"""Process start to the first timed call: imports, the CUDA context, the
built kernels' load (their build too, in a checkout's first run), the lens
compile, the inputs and the warm-up."""


def read(ctx):
    return ctx.setup_s
