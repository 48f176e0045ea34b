"""The traced window: ``torch.profiler`` over a few calls, read from its
Chrome trace into device intervals and the benchmark's own host spans.

The benchmark opens its spans with ``record_function`` (``bench.window``
around the whole traced window, ``bench.call``, ``bench.sync``,
``bench.update`` inside it); the profiler puts them on the same clock as
the device's operations.  Each window opens with ``torch.cuda._sleep``'s
short kernel and a synchronise, outside ``bench.window``: without it the
profiler has been seen to lose the first launches of a window.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

WINDOW = "bench.window"
# the Chrome trace's categories of work on the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PRIMER_CYCLES = 1000


class Trace(NamedTuple):
    """The traced window in seconds from its start: the device's operations
    ``(name, start, end)``, the host spans ``(name, start, end)`` and the
    window's length."""

    ops: List[Tuple[str, float, float]]
    spans: List[Tuple[str, float, float]]
    window_s: float


def span(name: str, on: bool):
    """A host span of the traced window, or nothing outside it."""
    return torch.profiler.record_function(name) if on else contextlib.nullcontext()


def record(fn: Callable[[], None]) -> Trace:
    """Run ``fn`` (which opens ``bench.window`` itself) under the profiler
    and read the trace."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        torch.cuda._sleep(PRIMER_CYCLES)
        torch.cuda.synchronize()
        fn()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        p.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return parse(events)


def parse(events: List[dict]) -> Trace:
    """The window's device operations and host spans from Chrome-trace
    events (``ts`` and ``dur`` in microseconds)."""
    win = [e for e in events if e.get("cat") == "user_annotation"
           and e.get("name") == WINDOW]
    if len(win) != 1:
        raise RuntimeError(f"the trace holds {len(win)} {WINDOW} spans")
    t0 = float(win[0]["ts"])
    t1 = t0 + float(win[0]["dur"])

    def clip(e):
        s = float(e["ts"])
        return max(s, t0), min(s + float(e.get("dur", 0.0)), t1)

    ops, spans = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat in DEVICE_CATS or cat == "user_annotation":
            s, t = clip(e)
            if t <= s:
                continue
            item = (e.get("name", "?"), (s - t0) * 1e-6, (t - t0) * 1e-6)
            (ops if cat in DEVICE_CATS else spans).append(item)
    spans = [s for s in spans if s[0] != WINDOW]
    return Trace(sorted(ops, key=lambda o: o[1]),
                 sorted(spans, key=lambda s: s[1]), (t1 - t0) * 1e-6)


def busy(trace: Trace) -> List[Tuple[float, float]]:
    """The union of the device's operations as disjoint intervals."""
    out: List[List[float]] = []
    for _, s, t in trace.ops:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return [(s, t) for s, t in out]


def busy_s(trace: Trace) -> float:
    return sum(t - s for s, t in busy(trace))


def idle_pct(trace: Trace) -> Optional[float]:
    """The share of the window in which nothing ran on the device, in %;
    None without a window or without any device operation."""
    if trace.window_s <= 0.0 or not trace.ops:
        return None
    return 100.0 * (trace.window_s - busy_s(trace)) / trace.window_s


def gaps(trace: Trace) -> List[Tuple[str, float]]:
    """Every idle stretch of the device in the window, labelled by the
    innermost benchmark span open on the host when it began."""
    out = []
    edge = 0.0
    for s, t in busy(trace) + [(trace.window_s, trace.window_s)]:
        if s > edge:
            open_ = [sp for sp in trace.spans if sp[1] <= edge < sp[2]]
            label = min(open_, key=lambda sp: sp[2] - sp[1])[0] if open_ else "none"
            out.append((label, s - edge))
        edge = max(edge, t)
    return out


def breakdown(trace: Trace, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, summed by name, and the
    longest idle gaps by what the host was doing: each at most ``top``."""
    by_name: Dict[str, float] = {}
    for name, s, t in trace.ops:
        by_name[name] = by_name.get(name, 0.0) + (t - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(gaps(trace), key=lambda g: -g[1])[:top]
    return {"device_ops": [[n, v] for n, v in ops],
            "idle_gaps": [[n, v] for n, v in idle]}


def device_s(trace: Trace) -> float:
    """The sum of every device operation's time in the window."""
    return sum(t - s for _, s, t in trace.ops)
