"""Profiling helpers.

Port of ``zoic_tpu/utils/profiling.py``: :func:`trace` records a
``torch.profiler`` trace of the enclosed block into a directory (open it
with Perfetto or TensorBoard), and :func:`time_fn` times a callable on the
card with CUDA events.  The JAX package's ``drain`` (a scalar read-back that
fenced a relay-attached TPU) has no counterpart: a CUDA event is the fence.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time
from typing import Callable, Iterator, Tuple

import torch

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_TRACE_DIR = os.path.join(_REPO, "build", "zoic_trace")


@contextlib.contextmanager
def trace(log_dir: str = DEFAULT_TRACE_DIR) -> Iterator[torch.profiler.profile]:
    """Record host and (with a card) device activity of the enclosed block
    into ``log_dir`` as a Chrome trace::

        with zoic_tpu_torch.utils.profiling.trace("build/tr") as prof:
            rays, stats = zt.create_rays(...)
        print(prof.key_averages().table(sort_by="cuda_time_total"))
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
