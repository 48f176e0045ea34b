"""The raytraced kernel's element traces a lit ray over the traced calls:
the pre-check's tightness on the card, at least 1.0 (a lit ray's last
trace is the one that lit it).

The program counts, while a profiler records, the aperture draws its
raytraced kernel makes and those that go on to the element trace
(``zoic.raytraced.draws``, ``zoic.raytraced.traces``;
``zoic_tpu_torch.utils.profiling.take_counters`` returns the totals and
resets them).  Read after the traced window, the traces are divided by
the traced calls' lit rays (non-zero weights, as
``raytraced_roofline_pct.frame`` counts them).  The note gives draws and
traces a ray, the share of draws the bound rejected and the kernel
instances seen in the trace.  Nothing where the program counted no draw,
or has no such counters."""

import re

NAME = "traces_per_lit_ray.frame"
DRAWS, TRACES = "zoic.raytraced.draws", "zoic.raytraced.traces"
INSTANCE = re.compile(r"raytraced_kernel<(\d+)>")


def _totals():
    """The program's totals, or None where it keeps none."""
    try:
        from zoic_tpu_torch.utils import profiling
        take = profiling.take_counters
    except (ImportError, AttributeError):
        return None
    return take()


def read(ctx):
    totals = _totals()
    if not totals or not totals.get(DRAWS):
        return None
    draws, traces = totals[DRAWS], totals.get(TRACES, 0)
    t = ctx.traced
    rays = sum(t["sizes"])
    lit = sum(int((w != 0).sum()) for w in t["weights"])
    found = sorted({int(m.group(1)) for name, _, _ in ctx.trace.ops
                    for m in [INSTANCE.search(name)] if m})
    ctx.note(f"{NAME}: {len(t['sizes'])} calls, {rays} rays, {lit} lit; "
             f"{draws} draws, {traces} traces; {draws / rays:.6g} draws and "
             f"{traces / rays:.6g} traces a ray; the bound rejected "
             f"{100.0 * (draws - traces) / draws:.4f}% of the draws; kernel "
             + (" ".join(f"<{v}>" for v in found) or "not in the trace"))
    if lit == 0:
        return None
    return traces / lit
