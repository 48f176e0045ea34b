"""The window over the frames it holds: a frame is ``Camera.update`` to the
next focus and the frame's rays; the window starts and ends at a frame
boundary."""


def read(ctx):
    n = ctx.window["calls"]
    return ctx.window["window_s"] / n if n else None
