"""Profiling helpers.

Port of ``zoic_tpu/utils/profiling.py``: :func:`trace` records a
``torch.profiler`` trace of the enclosed block into a directory (open it
with Perfetto or TensorBoard), and :func:`time_fn` times a callable on the
card with CUDA events.  The JAX package's ``drain`` (a scalar read-back that
fenced a relay-attached TPU) has no counterpart: a CUDA event is the fence.

:func:`span` names the port's steps in such a trace.  The package opens
its spans at its layer boundaries (``zoic.update``, ``zoic.compile`` and
its phases, ``zoic.camera.create_rays`` and the wrappers under it; the
list is in README.md), and only while a ``torch.profiler`` records: then
each is a ``record_function`` range on the profiler's clock, and each
kernel ties to the span that launched it.  With no profiler recording a
span is one flag read.

The cold path also keeps its own clock, with or without a profiler.
Spans named in :data:`CLOCK_ROOTS` (a focus change's ``zoic.update``, the
lens compile, a wrapper's table build or a library load: once a focus
change or a cache miss) start it, and every span opened while a clocked
span is open is clocked as its child: its path, whether a profiler
recorded, its start and end on ``time.perf_counter_ns`` and its self time
(its time less what its clocked children cover).  Under a profiler a
clocked span is still a ``record_function`` range.  A span opened outside
every clocked span (``zoic.camera.create_rays`` and all under it) is what
it was: no clock call, no record.  :func:`readback` is the cold path's one
synchronising copy from a card to the host, a clocked ``zoic.readback``
span that counts its bytes; :func:`clock_report` sums the records by path
and :func:`clock_reset` drops them.  One host thread is assumed to open
the clocked spans.

Beside the spans, the port keeps counters that the same flag switches on:
the raytraced kernel's aperture draws and the draws that go on to its
element trace (:data:`COUNTERS`).  While a profiler records, a wrapper
hands its kernel the device's totals (:func:`counter_totals`), which the
kernel adds to on the card; :func:`take_counters` reads them as ints and
resets them.  With no profiler recording nothing is counted or read.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler

Tensor = torch.Tensor

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_TRACE_DIR = os.path.join(_REPO, "build", "zoic_trace")


# the context every span returns while no profiler records
_NO_SPAN = contextlib.nullcontext()


# spans that start the clock: the cold steps, once a focus change or a
# cache miss
CLOCK_ROOTS = frozenset(("zoic.update", "zoic.compile", "zoic.tables.build",
                         "zoic.kernel.load"))
READBACK = "zoic.readback"
# most records the clock keeps; later ones are counted as dropped
CLOCK_CAP = 1 << 17

# the clocked spans open now, innermost last
_open: List["_Clocked"] = []
# (path, traced, start ns, end ns, self ns, bytes) a closed clocked span
_records: List[tuple] = []
_dropped = 0


def span(name: str):
    """A named range of the port's host work: a clocked span
    (:class:`_Clocked`) for a root of :data:`CLOCK_ROOTS` or inside a
    clocked span; else ``record_function(name)`` while a ``torch.profiler``
    records (as under :func:`trace`), or a shared no-op context, so that an
    unprofiled call on the hot path pays a list and a set test and no
    ``record_function`` (about 7 us each)."""
    if _open or name in CLOCK_ROOTS:
        return _Clocked(name)
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


class _Clocked:
    """A span on the clock, and a ``record_function`` range too while a
    profiler records; the bytes of a read-back are added to it."""

    __slots__ = ("name", "path", "traced", "range", "t0", "inner", "nbytes")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.traced = _autograd_profiler._is_profiler_enabled
        self.range = None
        if self.traced:
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.path = f"{_open[-1].path}/{self.name}" if _open else self.name
        self.inner = self.nbytes = 0
        _open.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        global _dropped
        t1 = time.perf_counter_ns()
        _open.pop()
        wall = t1 - self.t0
        if _open:
            _open[-1].inner += wall
        if len(_records) < CLOCK_CAP:
            _records.append((self.path, self.traced, self.t0, t1,
                             wall - self.inner, self.nbytes))
        else:
            _dropped += 1
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def readback(*ts: Tensor, pinned: bool = False) -> List[Tensor]:
    """The tensors ``ts`` of one device on the host, as CPU tensors: those
    off a card as they are; from a card, copies made in one clocked span
    ``zoic.readback`` that counts their bytes, the cold path's one way to
    wait for the card.  With ``pinned`` they go through page-locked buffers
    (PyTorch's caching host allocator) in one synchronise.  A
    ``torch.cuda`` sync-debug mode is lifted inside the copy alone."""
    if not ts or not ts[0].is_cuda:
        return list(ts)
    with span(READBACK) as s:
        mode = torch.cuda.get_sync_debug_mode()
        if mode:
            torch.cuda.set_sync_debug_mode(0)
        try:
            if pinned:
                out = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                       for t in ts]
                for b, t in zip(out, ts):
                    b.copy_(t, non_blocking=True)
                torch.cuda.current_stream(ts[0].device).synchronize()
            else:
                out = [t.cpu() for t in ts]
        finally:
            if mode:
                torch.cuda.set_sync_debug_mode(mode)
        if isinstance(s, _Clocked):
            s.nbytes = sum(t.numel() * t.element_size() for t in ts)
    return out


def clock_reset() -> None:
    """Drop the clock's records and its count of dropped ones."""
    global _dropped
    _records.clear()
    _dropped = 0


def clock_report(since: Optional[str] = None) -> dict:
    """The clock's records summed by span path and traced flag::

        {"spans": {(path, traced): {"count", "wall_s", "self_s", "max_s",
                                    "bytes"}},
         "readbacks": {traced: {"count", "bytes", "wall_s"}},
         "dropped": records not kept (over CLOCK_CAP)}

    A path names the clocked spans from the root down, joined by ``/``
    (``zoic.update/zoic.compile/zoic.compile.solve/zoic.readback``);
    ``traced`` says whether a profiler recorded when the span opened.
    With ``since``, only the records that start at or after the first root
    span of that name count (``since="zoic.update"``: from the first focus
    change on)."""
    recs = _records
    if since is not None:
        first = min((r[2] for r in recs if r[0] == since), default=None)
        recs = [r for r in recs if first is not None and r[2] >= first]
    spans: Dict[tuple, dict] = {}
    reads: Dict[bool, dict] = {}
    for path, traced, t0, t1, self_ns, nbytes in recs:
        row = spans.setdefault((path, traced), {
            "count": 0, "wall_s": 0.0, "self_s": 0.0, "max_s": 0.0,
            "bytes": 0})
        wall = (t1 - t0) * 1e-9
        row["count"] += 1
        row["wall_s"] += wall
        row["self_s"] += self_ns * 1e-9
        row["max_s"] = max(row["max_s"], wall)
        row["bytes"] += nbytes
        if path.rsplit("/", 1)[-1] == READBACK:
            r = reads.setdefault(traced, {"count": 0, "bytes": 0,
                                          "wall_s": 0.0})
            r["count"] += 1
            r["bytes"] += nbytes
            r["wall_s"] += wall
    return {"spans": spans, "readbacks": reads, "dropped": _dropped}


# the counters' names, in the order of a totals tensor's entries
COUNTERS = ("zoic.raytraced.draws", "zoic.raytraced.traces")
# device -> int64 [len(COUNTERS)] totals on it
_TOTALS: Dict[torch.device, torch.Tensor] = {}


def counter_totals(device) -> Optional[torch.Tensor]:
    """The ``int64`` totals of :data:`COUNTERS` on ``device`` (zeros at
    first use) while a ``torch.profiler`` records, for a wrapper to hand
    its kernel, which adds to them; else None, so that an unprofiled call
    pays one flag read and counts nothing."""
    if not _autograd_profiler._is_profiler_enabled:
        return None
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    totals = _TOTALS.get(dev)
    if totals is None:
        totals = _TOTALS[dev] = torch.zeros(len(COUNTERS), dtype=torch.int64,
                                            device=dev)
    return totals


def take_counters() -> Dict[str, int]:
    """Each counter of :data:`COUNTERS` summed over the devices as an int
    (a read-back that waits for the kernels that add to it), then every
    device's totals reset to 0."""
    out = dict.fromkeys(COUNTERS, 0)
    for totals in _TOTALS.values():
        for name, v in zip(COUNTERS, totals.tolist()):
            out[name] += v
        totals.zero_()
    return out


@contextlib.contextmanager
def trace(log_dir: str = DEFAULT_TRACE_DIR) -> Iterator[torch.profiler.profile]:
    """Record host and (with a card) device activity of the enclosed block
    into ``log_dir`` as a Chrome trace, the port's spans (:func:`span`)
    among them::

        with zoic_tpu_torch.utils.profiling.trace("build/tr") as prof:
            rays, stats = cam.create_rays(...)
        print(prof.key_averages().table(sort_by="cuda_time_total"))

    This is the operator's way to see where a call or a compile spends
    its time: each idle stretch of the card lies inside the ``zoic.*``
    span the host was in.
    """
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(
        activities=acts,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    ) as prof:
        yield prof


def time_fn(fn: Callable, make_args: Callable[[], Tuple], *, iters: int = 5,
            warmup: int = 1, bursts: int = 3, device="cuda") -> dict:
    """Seconds per call of ``fn(*make_args())``: ``bursts`` bursts of
    ``iters`` back-to-back calls, each call on fresh arguments made before
    its burst starts, timed between two CUDA events on ``device`` (host
    clock on the CPU).  Returns min, median and mean seconds per call."""
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    for _ in range(warmup):
        fn(*make_args())
    sync()
    per_call = []
    for _ in range(bursts):
        args = [make_args() for _ in range(iters)]
        sync()
        if cuda:
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            for a in args:
                fn(*a)
            t1.record()
            t1.synchronize()
            dt = t0.elapsed_time(t1) / 1e3
        else:
            start = time.perf_counter()
            for a in args:
                fn(*a)
            dt = time.perf_counter() - start
        per_call.append(dt / iters)
    return {
        "min": min(per_call),
        "median": statistics.median(per_call),
        "mean": sum(per_call) / len(per_call),
        "iters": iters,
        "bursts": bursts,
    }
