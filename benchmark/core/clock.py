"""The program's own clock of its cold path, read after the run.

``zoic_tpu_torch.utils.profiling`` times the focus change (``zoic.update``),
the lens compile under it and each of its phases, a kernel wrapper's table
build (``zoic.tables.build``) and library load (``zoic.kernel.load``), and
every read-back from the card inside them (``zoic.readback``), on
``time.perf_counter_ns`` whether or not a profiler records.
``clock_report`` sums the records by span path (the clocked spans from the
root down, joined by ``/``) and by whether a profiler recorded.  Read from
the first focus change on, the untraced records are the measured window's
frames: set-up compiled and built its tables before it, and the traced
window's frames are traced.  A program that keeps no such clock gives
nothing to read.
"""

from __future__ import annotations

from typing import Dict, Optional

FRAME = "zoic.update"
COMPILE = "zoic.update/zoic.compile"
READBACK = "zoic.readback"
ROOTS = ("zoic.tables.build", "zoic.kernel.load")


class Clock:
    """The report's rows by traced flag and path, and the untraced focus
    changes they cover."""

    def __init__(self, report: dict):
        self.rows: Dict[bool, Dict[str, dict]] = {False: {}, True: {}}
        for (path, traced), row in report["spans"].items():
            self.rows[bool(traced)][path] = row
        self.untraced = self.rows[False]
        self.traced = self.rows[True]
        self.frames = self.untraced.get(FRAME, {}).get("count", 0)
        self.dropped = report.get("dropped", 0)

    def children(self, parent: str, traced: bool = False) -> Dict[str, dict]:
        """The rows of the spans directly under ``parent``, by path."""
        return {p: r for p, r in self.rows[traced].items()
                if p.rsplit("/", 1)[0] == parent and p != parent}

    def readbacks(self) -> Dict[str, dict]:
        """The untraced read-backs' rows, by the path of their phase."""
        return {p.rsplit("/", 1)[0]: r for p, r in self.untraced.items()
                if p.rsplit("/", 1)[-1] == READBACK}


def read() -> Optional[Clock]:
    """The program's clock from the first focus change on, or None where
    the program keeps none or changed no focus untraced."""
    try:
        from zoic_tpu_torch.utils import profiling
        report = profiling.clock_report
    except (ImportError, AttributeError):
        return None
    got = Clock(report(since=FRAME))
    return got if got.frames else None
