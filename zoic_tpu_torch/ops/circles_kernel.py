"""The pupil pre-check's circle fit: its host steps, the wrappers of the
two reductions of ``csrc/circles.cu`` and their plain numpy versions.

The kernel replaces no TPU kernel: the JAX package fits the 2-circle cover
on the host in numpy (``zoic_tpu/pupil.py:_fit_circles_np`` and the
smoothing loop of ``build_precheck``).  Of the fit, two reductions are
large: the reach of the 241 candidate centres over each key's accepted
cover samples (a float64 ``[accepted x 241]`` matrix a key in numpy) and
the joint pass counts of every (negative, positive) centre pair over a
subsample.  :func:`fit_circles` writes the fit once: the two reductions
run on the card for CUDA tensors, where the cover traces already lie
(:func:`reach`, :func:`pick`), and in numpy for CPU tensors
(:func:`reach_plain`, :func:`pick_plain`); what is small and defines bits
stays on the host in numpy on both: the radii ``rk = sqrt(m2) * 1.01 +
0.005``, their squares, the pair's centres, ``q = rk ** 2 - a ** 2``, the
reject-all keys.  The kernel rounds every float64 step as numpy does, so
the fit on the card is bit-equal to the fit on the host.
:func:`reach_at` is the smoothing loop's reach at a key's own centres,
through the same reach entry, and :func:`reach_at_plain` its plain
version.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from ..utils.profiling import readback
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

# the fit's knobs, as in zoic_tpu/pupil.py
CIRCLE_CENTERS = 241          # x-axis centre grid over [-3, 3]
CIRCLE_SEL_SAMPLES = 12_500   # subsample for the pair-selection pass


def _host(x) -> np.ndarray:
    if isinstance(x, Tensor):
        return readback(x.detach())[0].numpy()
    return np.asarray(x)


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
    return readback(m2)[0].numpy()


def reach_plain(lx, ly, ok, centres) -> np.ndarray:
    """Plain numpy version of :func:`reach` for tensors on any device (or
    arrays): the same ``m2``, ``(px - centres) ** 2 + py ** 2`` over each
    key's accepted samples at once."""
    lxn, lyn, okn = _host(lx), _host(ly), _host(ok)
    cen = _host(centres)
    cen = np.broadcast_to(cen, (okn.shape[0], cen.shape[-1]))
    m2 = np.full(cen.shape, -1.0)
    for k in np.where(okn.any(1))[0]:
        px, py = lxn[k][okn[k]], lyn[k][okn[k]]
        d2 = (px[:, None] - cen[k][None, :]) ** 2 + (py**2)[:, None]
        m2[k] = d2.max(0)
    return m2


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
    rk2_t, cand_t, idx = (
        torch.from_numpy(a).to(dev, non_blocking=True) for a in (
            np.ascontiguousarray(rk2, np.float64),
            np.ascontiguousarray(cand, np.float64),
            np.concatenate([negi, posi]).astype(np.int32)))
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
    packed = readback(out)[0].numpy().view(np.uint64)
    return ((packed >> np.uint64(32)).astype(np.int64),
            (packed & np.uint64(0xFFFFFFFF)).astype(np.int64))


def pick_plain(lx, ly, rk2: np.ndarray, cand: np.ndarray, negi: np.ndarray,
               posi: np.ndarray, stride: int) -> Tuple[np.ndarray, np.ndarray]:
    """Plain numpy version of :func:`pick` for tensors on any device (or
    arrays), as the JAX package's fit counts: the joint pass counts a
    float32 product of 0/1 matrices (exact below 2**24 samples) and its
    ``argmin`` (the first flat index among equal counts)."""
    lxn, lyn = _host(lx), _host(ly)
    count = np.empty(lxn.shape[0], np.int64)
    flat = np.empty(lxn.shape[0], np.int64)
    for k in range(lxn.shape[0]):
        sx, sy = lxn[k][::stride], lyn[k][::stride]
        ds = (sx[:, None] - cand[None, :]) ** 2 + (sy**2)[:, None]
        inside = (ds <= rk2[k][None, :]).astype(np.float32)
        joint = inside[:, negi].T @ inside[:, posi]  # [Nn, Np] pass counts
        flat[k] = joint.argmin()
        count[k] = joint.flat[flat[k]]
    return count, flat


def fit_circles(lx: Tensor, ly: Tensor, ok: Tensor):
    """Per-key 2-circle intersection cover of the accepted cover samples
    ``ok`` of ``(lx, ly)``, ``[K, N]`` each.  For each key, picks x-axis
    centres ``(a1 <= 0, a2 >= 0)`` minimising the estimated candidate pass
    rate, with radii covering EVERY accepted sample plus the (x1.01,
    +0.005) margin.  Returns float64 arrays ``(a1, q1, a2, q2)`` with ``q_j
    = r_j^2 - a_j^2``; keys with no accepted sample get the reject-all
    circle (a=0, q=-1).  CUDA tensors run the two reductions on the card
    (a reach and a pick launch), CPU tensors in numpy; the bits are the
    same."""
    card = lx.device.type == "cuda"
    if card:
        lx, ly, ok = lx.contiguous(), ly.contiguous(), ok.contiguous()
    n_keys, n_s = ok.shape
    cand = np.linspace(-3.0, 3.0, CIRCLE_CENTERS)
    negi = np.where(cand <= 0.0)[0]
    posi = np.where(cand >= 0.0)[0]
    stride = max(1, n_s // CIRCLE_SEL_SAMPLES)
    # covering radius per candidate centre, over ALL accepted samples
    m2 = (reach if card else reach_plain)(
        lx, ly, ok, torch.from_numpy(cand).to(lx.device, non_blocking=True))
    live = np.where(m2[:, 0] >= 0.0)[0]
    rk = np.zeros((n_keys, cand.size))
    rk2 = np.zeros((n_keys, cand.size))
    for k in live:
        rk[k] = np.sqrt(m2[k]) * 1.01 + 0.005
        rk2[k] = rk[k][None, :] ** 2
    # pair selection on a subsample of ALL candidates (soundness does not
    # depend on this step, only the radii above bound anything): the card
    # picks for every key in one launch, the host for the live keys alone
    if card:
        flat = pick(lx, ly, rk2, cand, negi, posi, stride)[1][live]
    else:
        rows = torch.from_numpy(live)
        flat = pick_plain(lx[rows], ly[rows], rk2[live], cand, negi, posi,
                          stride)[1]
    a1 = np.zeros(n_keys)
    q1 = np.full(n_keys, -1.0)
    a2 = np.zeros(n_keys)
    q2 = np.full(n_keys, -1.0)
    for k, f in zip(live, flat):
        bi, bj = negi[f // posi.size], posi[f % posi.size]
        a1[k], a2[k] = cand[bi], cand[bj]
        q1[k] = rk[k][bi] ** 2 - a1[k] ** 2
        q2[k] = rk[k][bj] ** 2 - a2[k] ** 2
    return a1, q1, a2, q2


def reach_at(lx: Tensor, ly: Tensor, ok: Tensor,
             centres: np.ndarray) -> np.ndarray:
    """``m2[k, j]``, the max over key ``k``'s accepted samples of ``(lx -
    centres[k, j]) ** 2 + ly ** 2`` as numpy rounds it, -1 where the key
    has none: the smoothing loop's reach at a key's own centres, float64
    ``[K, J]``.  CUDA tensors launch the reach entry; CPU tensors run
    :func:`reach_at_plain`."""
    if lx.device.type == "cuda":
        return reach(lx.contiguous(), ly.contiguous(), ok.contiguous(),
                     torch.from_numpy(np.ascontiguousarray(
                         centres, np.float64)).to(lx.device,
                                                  non_blocking=True))
    return reach_at_plain(lx, ly, ok, centres)


def reach_at_plain(lx, ly, ok, centres: np.ndarray) -> np.ndarray:
    """Plain numpy version of :func:`reach_at` for tensors on any device:
    :func:`reach_plain` at the keys' own centres."""
    return reach_plain(lx, ly, ok, np.asarray(centres, np.float64))
