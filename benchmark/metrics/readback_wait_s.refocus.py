"""The seconds a frame's host waits on the card in the cold path, on the
program's own clock with no profiler: the untraced ``zoic.readback`` spans
(each a synchronising copy from the card) of the focus change's compile
and of the table builds after it, over the measured window's frames
(``core/clock.py``).  The note gives the read-backs a frame, their bytes
and their seconds by the phase that waits.  Nothing where the program
keeps no such clock."""

from benchmark.core import clock

NAME = "readback_wait_s.refocus"


def read(ctx):
    c = clock.read()
    if c is None:
        return None
    n = c.frames
    reads = c.readbacks()
    count = sum(r["count"] for r in reads.values())
    parts = [f"{phase.rsplit('/', 1)[-1]} x{r['count'] / n:.4g} "
             f"{r['bytes'] / r['count']:.0f} B {r['wall_s'] / n:.6f} s"
             for phase, r in sorted(reads.items(),
                                    key=lambda kv: -kv[1]["wall_s"])]
    wait = sum(r["wall_s"] for r in reads.values()) / n
    ctx.note(f"{NAME}: {n} untraced frames, {count / n:.4g} read-backs and "
             f"{sum(r['bytes'] for r in reads.values()) / n:.0f} B a frame, "
             f"{wait:.6f} s; " + "; ".join(parts))
    return wait
