"""The 95th percentile over all calls of the window of one call's time,
from entering ``Camera.create_rays`` until its outputs are complete on the
card (a synchronise), in ms."""

import numpy as np


def read(ctx):
    lat = ctx.window["latency_s"]
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
