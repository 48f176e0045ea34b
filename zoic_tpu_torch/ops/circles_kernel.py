"""The pupil pre-check's circle fit on the card: the wrapper of
``csrc/circles.cu`` and the host steps around it.

The kernel replaces no TPU kernel: the JAX package fits the 2-circle cover
on the host in numpy (``zoic_tpu/pupil.py:_fit_circles_np`` and the
smoothing loop of ``build_precheck``), and the port keeps that numpy as its
plain version (``pupil._fit_circles_np``, ``pupil._reach_np``).  Of the fit,
two reductions are large: the reach of the 241 candidate centres over each
key's accepted cover samples (a float64 ``[accepted x 241]`` matrix a key
in numpy) and the joint pass counts of every (negative, positive) centre
pair over a subsample.  :func:`fit_circles` and :func:`reach_at` run them
on the card for CUDA tensors, where the cover traces already lie, and keep
on the host, in numpy, what is small and defines bits: the radii ``rk =
sqrt(m2) * 1.01 + 0.005``, their squares, ``q = rk ** 2 - a ** 2``, the
reject-all keys.  The kernel rounds every float64 step as numpy does, so
the fit is bit-equal to the plain version.  CPU tensors run the plain
version itself.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from . import _launch

Tensor = torch.Tensor

# entry calls that launched on the card: a reach and a pick each count one
launches = 0

_REACH_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
_PICK_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                  + [ctypes.c_void_p])
# most centres the reach entry takes (its block size)
MAX_CENTRES = 256


def _check(*named) -> Tuple[int, int]:
    """Hold the named ``(name, tensor, dtype)`` cover traces to the first
    one's CUDA device and shape ``[K, N]``, their dtypes and contiguity;
    returns ``(K, N)``."""
    first = named[0][1]
    if first.device.type != "cuda" or first.dim() != 2:
        raise ValueError(f"the circle kernel takes [keys, samples] CUDA "
                         f"tensors, got {tuple(first.shape)} on "
                         f"{first.device}")
    for name, t, dtype in named:
        if (t.device != first.device or t.dtype != dtype
                or t.shape != first.shape):
            raise ValueError(
                f"{name} must be {str(dtype).replace('torch.', '')} of shape "
                f"{tuple(first.shape)} on {first.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous, got stride "
                             f"{t.stride()}")
    return first.shape[0], first.shape[1]


def reach(lx: Tensor, ly: Tensor, ok: Tensor, centres: Tensor) -> np.ndarray:
    """The reach entry: ``m2[k, c]``, the max over key ``k``'s accepted
    samples of ``(lx - centre) ** 2 + ly ** 2`` as numpy rounds it (a
    float64 difference and square, a float32 square, a float64 sum), for
    float64 ``centres`` ``[C]`` shared by every key or ``[K, C]`` a key's
    own; -1 for a key with no accepted sample.  Read back as a float64
    ``[K, C]`` array."""
    global launches
    n_keys, n = _check(("lx", lx, torch.float32), ("ly", ly, torch.float32),
                       ("ok", ok, torch.bool))
    per_key = centres.dim() == 2
    n_centres = centres.shape[-1]
    if (centres.dtype != torch.float64 or centres.device != lx.device
            or not centres.is_contiguous()
            or (per_key and centres.shape[0] != n_keys)
            or not 1 <= n_centres <= MAX_CENTRES):
        raise ValueError(
            f"centres must be contiguous float64 [C] or [{n_keys}, C] with "
            f"1 <= C <= {MAX_CENTRES} on {lx.device}, got {centres.dtype} "
            f"{tuple(centres.shape)} on {centres.device}")
    m2 = torch.full((n_keys, n_centres), -1.0, dtype=torch.float64,
                    device=lx.device)
    _launch.launch(
        _launch.bind("circles", "zoic_circles_reach_launch", _REACH_ARGTYPES),
        "circles reach", lx.device, lx.data_ptr(), ly.data_ptr(),
        ok.data_ptr(), centres.data_ptr(), m2.data_ptr(), n_keys, n,
        n_centres, int(per_key))
    launches += 1
    return m2.cpu().numpy()


def pick(lx: Tensor, ly: Tensor, rk2: np.ndarray, cand: np.ndarray,
         negi: np.ndarray, posi: np.ndarray,
         stride: int) -> Tuple[np.ndarray, np.ndarray]:
    """The pick entry: per key, the centre pair ``(negi[i], posi[j])``
    whose two circles of squared radii ``rk2[k]`` pass the fewest samples
    of the stride-``stride`` subsample of all the key's samples together,
    the least flat index ``i * len(posi) + j`` among equal counts.  Returns
    ``(count, flat)``, int64 ``[K]`` each."""
    global launches
    n_keys, n = _check(("lx", lx, torch.float32), ("ly", ly, torch.float32))
    dev = lx.device
    n_sub = -(-n // stride)
    words = -(-n_sub // 32)
    rk2_t = torch.from_numpy(np.ascontiguousarray(rk2, np.float64)).to(dev)
    cand_t = torch.from_numpy(np.ascontiguousarray(cand, np.float64)).to(dev)
    idx = torch.from_numpy(np.concatenate([negi, posi]).astype(np.int32)).to(dev)
    bits = torch.empty((n_keys, words, cand.size), dtype=torch.int32,
                       device=dev)
    out = torch.empty((n_keys,), dtype=torch.int64, device=dev)
    _launch.launch(
        _launch.bind("circles", "zoic_circles_pick_launch", _PICK_ARGTYPES),
        "circles pick", dev, lx.data_ptr(), ly.data_ptr(), rk2_t.data_ptr(),
        cand_t.data_ptr(), idx.data_ptr(), idx[negi.size:].data_ptr(),
        bits.data_ptr(), out.data_ptr(), n_keys, n, cand.size, stride,
        negi.size, posi.size)
    launches += 1
    packed = out.cpu().numpy().view(np.uint64)
    return ((packed >> np.uint64(32)).astype(np.int64),
            (packed & np.uint64(0xFFFFFFFF)).astype(np.int64))


def _fit_on_card(lx: Tensor, ly: Tensor, ok: Tensor):
    """:func:`fit_circles` through the two entries: ``pupil._fit_circles_np``
    with its two reductions on the card and every other step as it is
    there, in numpy on the host."""
    from ..pupil import _CIRCLE_CENTERS, _CIRCLE_SEL_SAMPLES

    n_keys, n_s = ok.shape
    cand = np.linspace(-3.0, 3.0, _CIRCLE_CENTERS)
    negi = np.where(cand <= 0.0)[0]
    posi = np.where(cand >= 0.0)[0]
    stride = max(1, n_s // _CIRCLE_SEL_SAMPLES)
    m2 = reach(lx, ly, ok, torch.from_numpy(cand).to(lx.device))
    live = np.where(m2[:, 0] >= 0.0)[0]
    rk = np.zeros((n_keys, cand.size))
    rk2 = np.zeros((n_keys, cand.size))
    for k in live:
        rk[k] = np.sqrt(m2[k]) * 1.01 + 0.005
        rk2[k] = rk[k][None, :] ** 2
    _, flat = pick(lx, ly, rk2, cand, negi, posi, stride)
    a1 = np.zeros(n_keys)
    q1 = np.full(n_keys, -1.0)
    a2 = np.zeros(n_keys)
    q2 = np.full(n_keys, -1.0)
    for k in live:
        bi, bj = negi[flat[k] // posi.size], posi[flat[k] % posi.size]
        a1[k], a2[k] = cand[bi], cand[bj]
        q1[k] = rk[k][bi] ** 2 - a1[k] ** 2
        q2[k] = rk[k][bj] ** 2 - a2[k] ** 2
    return a1, q1, a2, q2


def fit_circles(lx: Tensor, ly: Tensor, ok: Tensor):
    """Per-key 2-circle cover of the accepted cover samples ``ok`` of
    ``(lx, ly)``, ``[K, N]`` each: ``(a1, q1, a2, q2)`` float64 arrays as
    ``pupil._fit_circles_np`` returns them, bit for bit.  CUDA tensors
    launch ``csrc/circles.cu`` (a reach and a pick); CPU tensors run
    ``pupil._fit_circles_np``."""
    if lx.device.type == "cuda":
        return _fit_on_card(lx.contiguous(), ly.contiguous(), ok.contiguous())
    from ..pupil import _fit_circles_np, _np

    return _fit_circles_np(_np(lx), _np(ly), _np(ok))


def reach_at(lx: Tensor, ly: Tensor, ok: Tensor,
             centres: np.ndarray) -> np.ndarray:
    """``m2[k, j]``, the max over key ``k``'s accepted samples of ``(lx -
    centres[k, j]) ** 2 + ly ** 2`` as numpy rounds it, -1 where the key
    has none: the smoothing loop's reach at a key's own centres, float64
    ``[K, J]``.  CUDA tensors launch the reach entry; CPU tensors run
    ``pupil._reach_np``."""
    if lx.device.type == "cuda":
        return reach(lx.contiguous(), ly.contiguous(), ok.contiguous(),
                     torch.from_numpy(np.ascontiguousarray(
                         centres, np.float64)).to(lx.device))
    from ..pupil import _np, _reach_np

    return _reach_np(_np(lx), _np(ly), _np(ok), centres)
