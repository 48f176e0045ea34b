"""The device's busy time (the union of its operations) inside the
program's span ``zoic.compile`` (the lens compile of ``Camera.update``),
averaged over the traced frames, in s; with ``compile_host_s.refocus`` it
sums to the span's mean length.  Nothing where the program opens no such
span."""

from benchmark.core import spans


def read(ctx):
    got = spans.split(ctx.trace, "zoic.compile", ())
    return None if got is None else got[0].busy_s / got[0].n
