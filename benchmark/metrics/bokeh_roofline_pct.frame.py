"""The bokeh sampler's own share of its roofline in the traced calls, in
%: the floor of its work (``counts/bokeh.sampler_floor``: 8 B in and 8 B
out a draw, the image's tables once a call, no FLOPs, against the
published peaks) over the sum of the device operations named for the
sampler entry, ``bokeh_kernel<...>`` (never the plane entry's
``bokeh_planes_kernel``).  Read only where events >= card >= floor holds;
else nothing.  The note gives the kernel's ms a call and the instance
seen: tables in shared memory (``<true>``) or in global memory
(``<false>``)."""

import re

from benchmark.core import cells, peaks

KERNEL = "bokeh_kernel"
NAME = "bokeh_roofline_pct.frame"


def share(ctx, name, kernel, floor_fn):
    """The share of the operations of the kernel named ``kernel`` against
    ``floor_fn(cam, sizes)``; shared by the plane entry's reader.  The
    name must stand whole before its template arguments, so the sampler's
    ``bokeh_kernel`` never matches the plane entry's
    ``bokeh_planes_kernel``."""
    t = ctx.traced
    calls = len(t["sizes"])
    flops, nbytes = floor_fn(ctx.cam, t["sizes"])
    floor, by = peaks.floor_s(flops, nbytes)
    pattern = re.compile(rf"(?<![A-Za-z0-9_]){kernel}<(\w+)>")
    card, seen = 0.0, set()
    for op, s, e in ctx.trace.ops:
        m = pattern.search(op)
        if m:
            card += e - s
            seen.add({"true": "shared", "false": "global"}.get(m.group(1),
                                                               m.group(1)))
    ctx.note(f"{name}: {calls} calls, {sum(t['sizes'])} rays; {nbytes} B; "
             f"floor {floor:.6g} s (bound by {by}; card {ctx.card}); "
             f"{kernel} {card:.6g} s, "
             f"{card / calls * 1e3:.6g} ms a call; instance "
             f"{', '.join(sorted(seen)) or 'none'}; events "
             f"{t['events_s']:.6g} s")
    if not t["events_s"] >= card >= floor > 0.0:
        ctx.note(f"{name}: no reading (events >= card >= floor does not "
                 "hold)")
        return None
    return 100.0 * floor / card


def read(ctx):
    return share(ctx, NAME, KERNEL,
                 cells.module("counts", "bokeh").sampler_floor)
