"""The lens compile on the program's own clock, with no profiler: the mean
wall seconds of ``zoic.compile`` under an untraced ``zoic.update``
(``Camera.update`` to the frame's focus), over the measured window's
frames.  Set-up's compile (no ``zoic.update`` over it) and the traced
window's frames are left out (``core/clock.py``).

The note gives each phase of the compile (``zoic.compile.*``) and of its
pre-check (``zoic.precheck.*``) in rank order: its mean wall and self
seconds and its share of the compile's wall (a phase's wall holds its
read-backs, its self time does not); the compile's phases and self time
against its wall; the table builds and library loads a frame; the compile
traced over untraced, the profiler's cost on it; and the frame's rest,
``refocus_frame_s`` less the clocked update and table builds.  Nothing
where the program keeps no such clock."""

from benchmark.core import clock

NAME = "compile_wall_s.refocus"
PHASES = ("zoic.compile.", "zoic.precheck.")


def read(ctx):
    c = clock.read()
    comp = None if c is None else c.untraced.get(clock.COMPILE)
    if not comp:
        return None
    n = comp["count"]
    wall = comp["wall_s"] / n
    phases = sorted(
        ((p.rsplit("/", 1)[-1], r) for p, r in c.untraced.items()
         if p.startswith(clock.COMPILE + "/")
         and p.rsplit("/", 1)[-1].startswith(PHASES)),
        key=lambda kv: -kv[1]["wall_s"])
    parts = [f"{name} wall {r['wall_s'] / n:.6f} self {r['self_s'] / n:.6f} "
             f"share {100.0 * r['wall_s'] / comp['wall_s']:.2f}%"
             for name, r in phases]
    inner = sum(r["wall_s"] for r in c.children(clock.COMPILE).values())
    builds = []
    build_s = 0.0
    for root in clock.ROOTS:
        r = c.untraced.get(root)
        if r:
            builds.append(f"{root} {r['count'] / c.frames:.4g} a frame, "
                          f"{r['wall_s'] / c.frames:.6f} s")
            if root == "zoic.tables.build":
                build_s = r["wall_s"] / c.frames
    traced = c.traced.get(clock.COMPILE)
    ratio = (f"{(traced['wall_s'] / traced['count']) / wall:.4f} over "
             f"{traced['count']} traced compiles" if traced else "no traced "
             "compile")
    update = c.untraced[clock.FRAME]["wall_s"] / c.frames
    win = getattr(ctx, "window", None) or {}
    rest, upd = "not read", ""
    if win.get("calls"):
        frame = win["window_s"] / win["calls"]
        rest = (f"{frame - update - build_s:.6f} s of a {frame:.6f} s frame "
                f"({win['calls']} frames in the window)")
    if win.get("update_s"):
        upd_s = sum(win["update_s"]) / len(win["update_s"])
        upd = f"; the compile is {wall / upd_s:.4f} of update_s {upd_s:.6f}"
    ctx.note(f"{NAME}: {n} compiles in {c.frames} untraced frames, "
             f"{wall:.6f} s a frame, self {comp['self_s'] / n:.6f}; phases "
             f"and self {(inner + comp['self_s']) / comp['wall_s']:.6f} of "
             f"the wall; clocked update {update:.6f} s{upd}; "
             + "; ".join(parts)
             + "; " + ("; ".join(builds) or "no table build")
             + f"; traced over untraced {ratio}; the frame's rest {rest}"
             + (f"; {c.dropped} records dropped" if c.dropped else ""))
    return wall
