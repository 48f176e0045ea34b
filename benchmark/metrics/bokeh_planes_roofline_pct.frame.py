"""The bokeh plane entry's own share of its roofline in the traced calls,
in %: the floor of its work (``counts/bokeh.planes_floor``: 8 B out a
cell over the call's ``P * Bp`` retry-plane cells, the image's tables
once a call, no FLOPs, against the published peaks) over the sum of the
device operations named ``bokeh_planes_kernel<...>``.  Read only where
events >= card >= floor holds; else nothing.  The note gives the
kernel's ms a call and the instance seen (shared or global tables)."""

from benchmark.core import cells

KERNEL = "bokeh_planes_kernel"
NAME = "bokeh_planes_roofline_pct.frame"


def read(ctx):
    sampler = cells.module("metrics", "bokeh_roofline_pct.frame")
    return sampler.share(ctx, NAME, KERNEL,
                         cells.module("counts", "bokeh").planes_floor)
