"""The time inside the program's span ``zoic.compile`` (the lens compile
of ``Camera.update``) in which no operation runs on the device, averaged
over the traced frames, in s.  The note gives the same, and the device's
busy time, for each phase of the compile (``zoic.compile.*``) and of its
pupil pre-check (``zoic.precheck.*``), and for the compile outside its
phases.  Nothing where the program opens no such span."""

from benchmark.core import spans


def read(ctx):
    got = spans.split(ctx.trace, "zoic.compile",
                      ("zoic.compile.", "zoic.precheck."))
    if got is None:
        return None
    whole, phases = got
    n = whole.n
    outside = whole.span_s - sum(
        p.span_s for name, p in phases.items()
        if name.startswith("zoic.compile."))
    parts = [f"{name} host {p.host_s / n:.6f} card {p.busy_s / n:.6f}"
             for name, p in sorted(phases.items(),
                                   key=lambda kv: -kv[1].span_s)]
    ctx.note(f"compile_host_s.refocus: {n} compiles, a frame "
             f"{whole.span_s / n:.6f} s: host {whole.host_s / n:.6f}, card "
             f"{whole.busy_s / n:.6f}; "
             + "; ".join(parts)
             + f"; outside the phases {outside / n:.6f} s")
    return whole.host_s / n
