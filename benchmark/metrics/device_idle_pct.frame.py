"""The share of the traced window in which no operation runs on the
device, in %."""

from benchmark.core import profile


def read(ctx):
    return profile.idle_pct(ctx.trace)
