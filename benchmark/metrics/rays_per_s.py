"""Every ray of every call in the window over the window, which ends when
the last call's outputs are complete on the card."""


def read(ctx):
    return ctx.window["rays"] / ctx.window["window_s"]
