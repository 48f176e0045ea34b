"""What every kernel wrapper of the port does around its launch: bind the
library's C function once, ask the card's occupancy once, check the flat
inputs, allocate the outputs, launch on PyTorch's current stream and raise
on a launch error.

The wrappers (:func:`ops.trace_kernel.raytraced_fused`,
:func:`ops.trace_kernel.raytraced_rays`,
:func:`ops.trace_kernel.thinlens_rays`,
:func:`ops.bokeh_kernel.sample_fused`,
:func:`ops.bokeh_kernel.planes_fused`) keep what is theirs: the tables of
their state, their arguments, their grid and their launch counter.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from ..utils.profiling import span
from . import _build

Tensor = torch.Tensor

# the lane-counting builds of the camera kernels (csrc/common.cuh)
COUNT_DEFINE = "ZOIC_COUNT_LANES"

_BOUND: dict = {}
# (name, symbol, defines, query arguments, device index) -> (SMs, blocks
# per SM)
_PER_SM: dict = {}


def _raw_stream(index: int) -> int:
    """The current stream's handle as an int, without building a Stream
    object (tens of microseconds per launch)."""
    return torch._C._cuda_getCurrentRawStream(index)


def bind(name: str, symbol: str, argtypes: Sequence, *,
         defines: Sequence[str] = ()):
    """The C function ``symbol`` of ``csrc/<name>.cu`` (built at first use)
    with its argument types set; bound once per library and symbol, in the
    span ``zoic.kernel.load``.  The function returns a CUDA error code as
    an int."""
    key = (name, symbol, tuple(defines))
    fn = _BOUND.get(key)
    if fn is None:
        with span("zoic.kernel.load"):
            fn = getattr(_build.load(name, defines=defines), symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _BOUND[key] = fn
    return fn


def blocks_per_sm(name: str, symbol: str, argtypes: Sequence,
                  dev: torch.device, *args,
                  defines: Sequence[str] = ()) -> Tuple[int, int]:
    """``(SMs, blocks per SM)`` of ``dev``'s card for the kernel behind the
    occupancy query ``symbol(*args)`` of ``csrc/<name>.cu``: asked once
    per arguments and card, in the span ``zoic.kernel.load``.  Raises when
    the query gives less than one block (no such instance, no block fits
    an SM, or the query failed)."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    key = (name, symbol, tuple(defines), args, index)
    hit = _PER_SM.get(key)
    if hit is None:
        with span("zoic.kernel.load"):
            fn = bind(name, symbol, argtypes, defines=defines)
            with torch.cuda.device(index):
                per_sm = fn(*args)
            if per_sm < 1:
                raise RuntimeError(
                    f"{name} kernel: {symbol}{args} gave {per_sm}: no such "
                    f"instance, no block fits an SM, or the query failed")
            sms = torch.cuda.get_device_properties(
                index).multi_processor_count
            hit = _PER_SM[key] = (sms, per_sm)
    return hit


def check_flat(named: Sequence[Tuple[str, Tensor]],
               dtype: torch.dtype = torch.float32) -> Tuple[int, torch.device]:
    """Hold the flat ``[B]`` inputs of a kernel to one device (the first
    one's), ``dtype``, one shape and contiguity; returns ``(B, device)``.
    A kernel reads its inputs in place, so nothing is copied here."""
    first = named[0][1]
    b, dev = first.shape[0], first.device
    for name, t in named:
        if t.device != dev or t.dtype != dtype or t.shape != (b,):
            raise ValueError(
                f"{name} must be {str(dtype).replace('torch.', '')} of shape "
                f"({b},) on {dev}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(
                f"{name} must be contiguous, got stride {t.stride()}; pass "
                f"{name}.contiguous()"
            )
    return b, dev


def empty(dev: torch.device, *specs) -> Tuple[Tensor, ...]:
    """One uninitialised output on ``dev`` per ``(shape, dtype)``: each owns
    its storage."""
    return tuple(torch.empty(shape, dtype=dtype, device=dev)
                 for shape, dtype in specs)


def launch(fn, what: str, dev: torch.device, *args) -> None:
    """Call the bound C function ``fn(*args, stream)`` on ``dev``'s current
    stream; the device context is entered only when ``dev`` is not the
    current device.  Raises on a refused launch: there is no fallback."""
    current = torch.cuda.current_device()
    index = current if dev.index is None else dev.index
    if index == current:
        err = fn(*args, _raw_stream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, _raw_stream(index))
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def read_counts(name: str, n: int) -> Tuple[int, ...]:
    """The ``n`` lane-use counters of ``csrc/<name>.cu``'s counting build,
    read after the card has finished."""
    out = (ctypes.c_ulonglong * n)()
    fn = bind(name, f"zoic_{name}_counts_read", [ctypes.c_void_p],
              defines=(COUNT_DEFINE,))
    err = fn(ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"{name} counters: CUDA error {err}")
    return tuple(int(v) for v in out)


def reset_counts(name: str) -> None:
    """Zero the lane-use counters of ``csrc/<name>.cu``'s counting build."""
    err = bind(name, f"zoic_{name}_counts_reset", [],
               defines=(COUNT_DEFINE,))()
    if err != 0:
        raise RuntimeError(f"{name} counters: CUDA error {err}")
