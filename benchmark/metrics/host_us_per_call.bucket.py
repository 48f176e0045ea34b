"""The benchmark's span around each call of the window, by the host's
clock, from entering ``Camera.create_rays`` until it returns (before the
synchronise), averaged over all calls, in us."""


def read(ctx):
    host = ctx.window["host_s"]
    return sum(host) / len(host) * 1e6 if host else None
