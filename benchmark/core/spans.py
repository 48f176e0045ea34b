"""The program's own spans in the traced window.

``zoic_tpu_torch`` opens its spans (``zoic.update``, ``zoic.compile`` and
its phases, ``zoic.camera.create_rays`` and the steps under it) with
``record_function`` while a profiler records, so they come in the trace
beside the benchmark's own (``core/profile.py``), on the device's clock.
Here a span's time splits into the part in which the device ran some
operation (the union of the operations, clipped to the span) and the
rest, in which the device waited on the host.  A program that opens no
such span gives nothing to read.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from . import profile

Interval = Tuple[float, float]


def busy_within(busy: List[Interval], s: float, t: float) -> float:
    """Seconds of ``[s, t]`` covered by the disjoint intervals ``busy``."""
    return sum(max(0.0, min(t, b1) - max(s, b0)) for b0, b1 in busy)


class Split:
    """Spans of one name over a number of occurrences of an outer span:
    their seconds, the device's busy seconds inside them, and how many."""

    def __init__(self):
        self.n, self.span_s, self.busy_s, self.max_s = 0, 0.0, 0.0, 0.0

    def add(self, s: float, t: float, busy: float) -> None:
        self.n += 1
        self.span_s += t - s
        self.busy_s += busy
        self.max_s = max(self.max_s, t - s)

    @property
    def host_s(self) -> float:
        """Seconds of the spans in which the device ran nothing."""
        return self.span_s - self.busy_s


def split(trace: profile.Trace, outer: str,
          prefixes: Tuple[str, ...] = ("zoic.",)
          ) -> Optional[Tuple[Split, Dict[str, Split]]]:
    """The spans ``outer`` of the window, and each span whose name starts
    with one of ``prefixes`` and lies inside one of them, by name; None
    where the window holds no span ``outer``."""
    outers = [(s, t) for n, s, t in trace.spans if n == outer]
    if not outers:
        return None
    busy = profile.busy(trace)
    whole, inner = Split(), {}
    for s, t in outers:
        whole.add(s, t, busy_within(busy, s, t))
    for n, s, t in trace.spans:
        if n == outer or not n.startswith(prefixes):
            continue
        if any(s0 <= s and t <= t0 for s0, t0 in outers):
            inner.setdefault(n, Split()).add(s, t, busy_within(busy, s, t))
    return whole, inner
