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
from typing import Callable, Dict, Iterator, Optional, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_TRACE_DIR = os.path.join(_REPO, "build", "zoic_trace")


# the context every span returns while no profiler records
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A named range of the port's host work: ``record_function(name)``
    while a ``torch.profiler`` records (as under :func:`trace`), else a
    shared no-op context, so that an unprofiled call pays one flag read
    and no ``record_function`` (about 7 us each)."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


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
