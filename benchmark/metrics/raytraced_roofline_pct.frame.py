"""The raytraced kernel's own share of its roofline in the traced calls,
in %: the floor of its work (``counts/raytraced_kernel.py``: 16 B in and
32 B out a ray, one full trace a lit ray, against the published peaks)
over the sum of the device operations whose name holds
``raytraced_kernel``.  The lit rays are the traced calls' non-zero
weights, as ``raygen_roofline_pct`` counts them.  Read only where events
>= card >= floor holds; else nothing.  The note gives the kernel's ms a
call and the lit share."""

from benchmark.core import cells, peaks

KERNEL = "raytraced_kernel"
NAME = "raytraced_roofline_pct.frame"


def read(ctx):
    t = ctx.traced
    calls, rays = len(t["sizes"]), sum(t["sizes"])
    lit = sum(int((w != 0).sum()) for w in t["weights"])
    count = cells.module("counts", "raytraced_kernel")
    flops, nbytes = count.floor(ctx.cam, ctx.lens_path, rays, lit)
    floor, by = peaks.floor_s(flops, nbytes)
    card = sum(e - s for name, s, e in ctx.trace.ops if KERNEL in name)
    ctx.note(f"{NAME}: {calls} calls, {rays} rays, {lit} lit "
             f"({100.0 * lit / rays:.4f}%); {flops} FLOP, {nbytes} B; "
             f"floor {floor:.6g} s (bound by {by}; card {ctx.card}); "
             f"{KERNEL} {card:.6g} s, {card / calls * 1e3:.6g} ms a call; "
             f"events {t['events_s']:.6g} s")
    if not t["events_s"] >= card >= floor > 0.0:
        ctx.note(f"{NAME}: no reading (events >= card >= floor does not "
                 "hold)")
        return None
    return 100.0 * floor / card
