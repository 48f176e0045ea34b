"""The mean length of the program's span ``zoic.camera.create_rays`` (all
of ``Camera.create_rays``: what a caller waits for on the host) over the
traced calls, in us.  The note gives, for each ``zoic.*`` span inside it,
how many a call, the mean and the longest.  Nothing where the program
opens no such span."""

from benchmark.core import spans


def read(ctx):
    got = spans.split(ctx.trace, "zoic.camera.create_rays")
    if got is None:
        return None
    whole, steps = got
    n = whole.n
    parts = [f"{name} x{p.n / n:g} mean {p.span_s / p.n * 1e6:.1f} max "
             f"{p.max_s * 1e6:.1f}"
             for name, p in sorted(steps.items(),
                                   key=lambda kv: -kv[1].span_s)]
    ctx.note(f"glue_us_per_call.frame: {n} calls, mean "
             f"{whole.span_s / n * 1e6:.1f} us, max {whole.max_s * 1e6:.1f} "
             f"us, the card busy {whole.busy_s / n * 1e6:.1f} us of it; "
             + "; ".join(parts))
    return whole.span_s / n * 1e6
