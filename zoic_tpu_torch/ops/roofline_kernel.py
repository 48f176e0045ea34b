"""Op-rate microbenchmark kernel: the CUDA kernel's wrapper and its plain
PyTorch version.

Port of the TPU kernel ``tools/roofline.py:_make_kernel`` (launched by
``measure``): ``reps`` iterations of a loop-carried chain of one op class
(:data:`CASES`, the bodies of ``tools/roofline.py:_chain``) over
``n_streams`` independent streams of the input block ``x[n_streams, tile,
128]``, the streams then summed (xor-ed for ``i32mix``) into a ``[tile,
128]`` block that every one of the ``grid`` steps writes again, so the
output is ``[grid * tile, 128]``.

:func:`roofline_fused` launches ``csrc/roofline.cu`` for CUDA tensors, built
with ``--fmad=false`` as every kernel of the port; CPU tensors run
:func:`roofline_plain`.  Both take the chain's operands ``a`` and ``b`` as
keywords, :data:`A` and :data:`B` by default: ``reps=1`` with ``a=-0.0``
(which leaves every value as it is, ``-0`` included) holds one step of
``sqrt``, ``div`` or ``recip`` to PyTorch's own operation on any operands.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

Tensor = torch.Tensor

# launches of the CUDA kernel by roofline_fused (plain CPU runs not counted)
launches = 0

# the cases of tools/roofline.py, in the order of csrc/roofline.cu's Case
CASES = ("fma", "mul", "add", "sqrt", "rsqrt", "div", "recip", "abs",
         "select", "min", "floor", "i32mix", "f2i")
# element-ops per chain iteration (tools/roofline.py:_chain)
K_OPS = {"fma": 1, "mul": 1, "add": 1, "sqrt": 2, "rsqrt": 2, "div": 2,
         "recip": 2, "abs": 2, "select": 3, "min": 2, "floor": 2,
         "i32mix": 3, "f2i": 3}
LANES = 128
A, B = 0.5, 1.25       # the chains' operands (0 and 0 for i32mix)
I32_MUL = -1975592817  # the i32mix multiplier as int32
STREAMS = (1, 2, 4, 8)  # stream counts the kernel is instantiated for


def dtype_of(name: str) -> torch.dtype:
    return torch.int32 if name == "i32mix" else torch.float32


def chain_step(name: str, x: Tensor, a: Tensor, b: Tensor) -> Tensor:
    """One iteration of case ``name`` on ``x``; ``a`` and ``b`` are 0-d
    tensors on ``x``'s device, so that ``b / x`` is a true division."""
    if name == "fma":
        return x * a + b
    if name == "mul":
        return x * a
    if name == "add":
        return x + a
    if name == "sqrt":
        return torch.sqrt(x) + a
    if name == "rsqrt":
        return torch.rsqrt(x) + a
    if name == "div":
        return b / x + a
    if name == "recip":
        return torch.reciprocal(x) + a
    if name == "abs":
        return torch.abs(x) + a
    if name == "select":
        return torch.where(x > a, x, b) + a
    if name == "min":
        return torch.minimum(x, a) + b
    if name == "floor":
        return torch.floor(x) + a
    if name == "i32mix":
        h = x * torch.tensor(I32_MUL, dtype=torch.int32, device=x.device)
        return h ^ (h >> 13)
    if name == "f2i":
        return x.to(torch.int32).to(torch.float32) + a
    raise ValueError(f"unknown roofline case {name!r}")


def scalars(name: str, a=None, b=None) -> tuple:
    """The chain's ``(a, b)``: the arguments where given, else the case's
    defaults (:data:`A`, :data:`B`; 0 and 0 for ``i32mix``)."""
    da, db = (0, 0) if name == "i32mix" else (A, B)
    return (da if a is None else a), (db if b is None else b)


def operands(name: str, device, a=None, b=None):
    """The chain's ``(a, b)`` (:func:`scalars`) as 0-d tensors on
    ``device``."""
    return tuple(torch.tensor(s, dtype=dtype_of(name), device=device)
                 for s in scalars(name, a, b))


def _check(name: str, x: Tensor, grid: int, reps: int) -> None:
    if name not in CASES:
        raise ValueError(f"unknown roofline case {name!r}; cases: {CASES}")
    if x.dtype != dtype_of(name) or x.dim() != 3 or x.shape[2] != LANES:
        raise ValueError(
            f"x must be {dtype_of(name)} of shape (n_streams, tile, {LANES}),"
            f" got {x.dtype} {tuple(x.shape)}"
        )
    if grid < 1 or reps < 0:
        raise ValueError(f"grid must be >= 1 and reps >= 0, got {grid}, {reps}")


def roofline_plain(name: str, x: Tensor, grid: int, reps: int, *, a=None,
                   b=None) -> Tensor:
    """Plain PyTorch version on any device: the chain over the whole block
    as tensor ops, the streams combined, the block tiled over ``grid``."""
    _check(name, x, grid, reps)
    a, b = operands(name, x.device, a, b)
    xs = list(x.unbind(0))
    for _ in range(reps):
        xs = [chain_step(name, v, a, b) for v in xs]
    acc = xs[0]
    for v in xs[1:]:
        acc = acc ^ v if name == "i32mix" else acc + v
    return acc.repeat(grid, 1)


def _kernel_fn():
    fn = _build.load("roofline").zoic_roofline_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int64,
                       ctypes.c_int, ctypes.c_float, ctypes.c_float,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def roofline_fused(name: str, x: Tensor, grid: int, reps: int, *, a=None,
                   b=None) -> Tensor:
    """Case ``name`` over ``x[n_streams, tile, 128]`` (float32, int32 for
    ``i32mix``) for ``grid`` steps of ``reps`` iterations with the operands
    ``a`` and ``b`` (:func:`scalars`): returns ``[grid * tile, 128]``.  CUDA
    tensors launch ``csrc/roofline.cu``; CPU tensors run
    :func:`roofline_plain`."""
    global launches
    if x.device.type == "cpu":
        return roofline_plain(name, x, grid, reps, a=a, b=b)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check(name, x, grid, reps)
    n_streams, tile = x.shape[0], x.shape[1]
    if n_streams not in STREAMS:
        raise ValueError(f"n_streams must be one of {STREAMS}, got {n_streams}")
    x = x.contiguous()
    out = torch.empty((grid * tile, LANES), dtype=x.dtype, device=x.device)
    a, b = scalars(name, a, b)
    fn = _kernel_fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(CASES.index(name), x.data_ptr(), out.data_ptr(), n_streams,
                 tile * LANES, out.numel(), reps, a, b, stream)
    if err != 0:
        raise RuntimeError(f"roofline kernel launch failed: CUDA error {err}")
    launches += 1
    return out
