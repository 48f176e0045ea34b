"""The benchmark's span around ``Camera.update`` (the lens compile at the
frame's focus), ending in a synchronise, averaged over the window's
frames, in s."""


def read(ctx):
    upd = ctx.window["update_s"]
    return sum(upd) / len(upd) if upd else None
