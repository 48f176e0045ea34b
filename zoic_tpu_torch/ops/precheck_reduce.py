"""The pupil pre-check's reductions over its cover traces: plain PyTorch
operations on the card where the traces lie, and their plain numpy
versions.

No TPU kernel is replaced: the JAX package fits the whole pre-check on
the host in numpy (``zoic_tpu/pupil.py:build_precheck``).
``pupil.build_precheck`` keeps on the host what is small or what the card
would round otherwise: numpy's ``arctan2`` and ``cos`` of the cover
samples (the azimuth bins, the three harmonics' cosines), every
``lstsq``, every step on a key's few values and every sum that is not
order-free.  What is left here are elementwise IEEE operations over
``[rows, samples]`` and their maxima or 0/1 counts, which give numpy's
bits in any order: a correctly rounded float32 square root
(``optics.sqrt``: PyTorch's CPU kernel is not), float64 products
and sums, a maximum, a count.  CUDA tensors run them on the card, in
eager operations (no two of them contract into an FMA); CPU tensors and
arrays run the ``*_plain`` versions, the JAX package's numpy.  Either
reads back only a float64 value or a count a row.

Each takes the cover samples ``lx``, ``ly`` (float32) and ``ok`` (bool)
of shape ``[R, N]`` and computes ``rr = lx * lx + ly * ly`` and ``rho =
sqrt(rr)`` in float32, as numpy does.  A row's float64 coefficients meet
the float32 samples as ``[R, 1]``: numpy promotes a float32 array against
a float64 scalar, PyTorch not against a 0-d float64 tensor.  ``ops/``
imports nothing from ``pupil``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..optics import sqrt
from ..utils.profiling import readback
from .circles_kernel import reach_at_plain

Tensor = torch.Tensor

# reductions that ran on the card (one a call)
calls = 0


def on_card(t) -> bool:
    """Whether the reductions over the samples ``t`` run on the card:
    CUDA tensors do, CPU tensors and arrays take the plain versions."""
    return isinstance(t, Tensor) and t.device.type == "cuda"


def host(*ts: Tensor):
    """The samples ``ts`` as numpy arrays, for the host's trig: from the
    card through page-locked buffers (PyTorch's caching host allocator, so
    a recompile reuses them), in one synchronise."""
    if not ts[0].is_cuda:
        return [_host(t) for t in ts]
    return [b.numpy() for b in readback(*ts, pinned=True)]


def routed(a: np.ndarray, like):
    """The host array ``a`` where the reductions over ``like`` read it:
    on ``like``'s device, through a page-locked buffer, when they run on
    the card; else as it is."""
    if not on_card(like):
        return a
    t = torch.from_numpy(np.ascontiguousarray(a))
    if like.is_cuda:
        t = t.pin_memory().to(like.device, non_blocking=True)
    return t


def _host(x) -> np.ndarray:
    if isinstance(x, Tensor):
        return readback(x.detach())[0].numpy()
    return np.asarray(x)


def _to_card(like, *arrays):
    """Counts a reduction run on the card, and puts the host arrays
    ``arrays`` (a row's coefficients) beside the samples ``like``."""
    global calls
    calls += 1
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(
                     like.device, non_blocking=True)
                 for a in arrays)


def _bound(coef, cos):
    """The harmonic bound ``((c0 + c1 cos phi) + c2 cos 2phi) + c4 cos
    4phi`` in float64, for ``coef`` ``[4, R]`` float64 and ``cos``
    ``[3, R, N]`` float32: the same expression in numpy and PyTorch."""
    c0, c1, c2, c4 = (c[:, None] for c in coef)
    return c0 + c1 * cos[0] + c2 * cos[1] + c4 * cos[2]


def bin_max(lx, ly, ok, bins: np.ndarray, n_bins: int) -> np.ndarray:
    """``rho_max[k, b]``: the max of ``rho`` over row ``k``'s accepted
    samples whose azimuth bin ``bins`` (ints in ``[0, n_bins)``, ``[R,
    N]``) is ``b``, 0 where there is none; float64 ``[R, n_bins]``."""
    if not on_card(lx):
        return bin_max_plain(lx, ly, ok, bins, n_bins)
    (idx,) = _to_card(lx, bins.astype(np.uint8))
    rho = sqrt(lx * lx + ly * ly)
    m = torch.zeros((lx.shape[0], n_bins), dtype=torch.float32,
                    device=lx.device)
    m.scatter_reduce_(1, idx.long(), torch.where(ok, rho, 0.0), "amax")
    return _host(m).astype(np.float64)


def bin_max_plain(lx, ly, ok, bins, n_bins) -> np.ndarray:
    lxn, lyn, okn = _host(lx), _host(ly), _host(ok)
    rho = np.sqrt(lxn * lxn + lyn * lyn)
    m = np.zeros((lxn.shape[0], n_bins))
    for k in range(lxn.shape[0]):
        np.maximum.at(m[k], bins[k][okn[k]], rho[k][okn[k]])
    return m


def harmonic_excess(lx, ly, ok, cos, coef: np.ndarray) -> np.ndarray:
    """The max over row ``r``'s accepted samples of ``rho - bound`` (float64;
    ``_bound`` of ``coef[:, r]`` and the row's cosines ``cos``, ``[3, R,
    N]`` float32 from :func:`routed`), -inf where there is none;
    float64 ``[R]``."""
    if not on_card(lx):
        return harmonic_excess_plain(lx, ly, ok, cos, coef)
    (coef,) = _to_card(lx, coef)
    rho = sqrt(lx * lx + ly * ly)
    v = torch.where(ok, rho - _bound(coef, cos), -torch.inf)
    return _host(v.amax(1))


def harmonic_excess_plain(lx, ly, ok, cos, coef) -> np.ndarray:
    lxn, lyn, okn = _host(lx), _host(ly), _host(ok)
    rho = np.sqrt(lxn * lxn + lyn * lyn)
    return np.where(okn, rho - _bound(coef, cos), -np.inf).max(1)


def harmonic_share(lx, ly, cos, coef: np.ndarray) -> np.ndarray:
    """The share of each row's samples, accepted or not, with ``rho <=
    bound`` (as :func:`harmonic_excess`); float64 ``[R]``."""
    if not on_card(lx):
        return harmonic_share_plain(lx, ly, cos, coef)
    (coef,) = _to_card(lx, coef)
    rho = sqrt(lx * lx + ly * ly)
    return _host((rho <= _bound(coef, cos)).sum(1)) / lx.shape[1]


def harmonic_share_plain(lx, ly, cos, coef) -> np.ndarray:
    lxn, lyn = _host(lx), _host(ly)
    rho = np.sqrt(lxn * lxn + lyn * lyn)
    return (rho <= _bound(coef, cos)).mean(1)


def circle_excess(lx, ly, ok, two_a: np.ndarray) -> np.ndarray:
    """``t[r, j]``, the max over row ``r``'s accepted samples of ``rr -
    two_a[r, j] * lx`` (float64), -inf where there is none; float64 ``[R,
    J]``.  A circle ``j`` of centre ``(a, 0)`` and ``q = r^2 - a^2`` holds
    them all iff ``t <= q`` for ``two_a = 2 * a``."""
    if not on_card(lx):
        return circle_excess_plain(lx, ly, ok, two_a)
    (two_a,) = _to_card(lx, two_a)
    rr = lx * lx + ly * ly
    v = rr[:, None] - two_a[:, :, None] * lx[:, None]
    return _host(torch.where(ok[:, None], v, -torch.inf).amax(2))


def circle_excess_plain(lx, ly, ok, two_a) -> np.ndarray:
    lxn, lyn, okn = _host(lx), _host(ly), _host(ok)
    t = np.full(two_a.shape, -np.inf)
    for k in np.where(okn.any(1))[0]:
        x, y = lxn[k][okn[k]], lyn[k][okn[k]]
        rr = x * x + y * y
        for j in range(two_a.shape[1]):
            t[k, j] = (rr - two_a[k, j] * x).max()
    return t


def circle_share(lx, ly, two_a: np.ndarray, q: np.ndarray) -> np.ndarray:
    """The share of each row's samples, accepted or not, inside every
    circle ``j``: ``rr - two_a[r, j] * lx <= q[r, j]`` (float64); float64
    ``[R]``."""
    if not on_card(lx):
        return circle_share_plain(lx, ly, two_a, q)
    two_a, q = _to_card(lx, two_a, q)
    rr = lx * lx + ly * ly
    inside = (rr[:, None] - two_a[:, :, None] * lx[:, None]) <= q[:, :, None]
    return _host(inside.all(1).sum(1)) / lx.shape[1]


def circle_share_plain(lx, ly, two_a, q) -> np.ndarray:
    lxn, lyn = _host(lx), _host(ly)
    rr = lxn * lxn + lyn * lyn
    inside = np.ones(lxn.shape, bool)
    for j in range(two_a.shape[1]):
        inside &= (rr - two_a[:, j, None] * lxn) <= q[:, j, None]
    return inside.mean(1)


def circle_reach(lx, ly, ok, centres: np.ndarray) -> np.ndarray:
    """``m2[r, j]``, the max over row ``r``'s accepted samples of ``(lx -
    centres[r, j]) ** 2 + ly ** 2`` (a float64 difference and square, a
    float32 square, a float64 sum), -1 where there is none; float64 ``[R,
    J]``: ``circles_kernel.reach_at_plain``'s value, here in PyTorch on
    the card, so that a compile launches the circle kernel for its fit
    alone (three launches with the LUT, two without)."""
    if not on_card(lx):
        return reach_at_plain(lx, ly, ok, centres)
    (centres,) = _to_card(lx, centres)
    d = lx[:, None] - centres[:, :, None]
    v = d * d + (ly * ly)[:, None]
    return _host(torch.where(ok[:, None], v, -torch.inf).amax(2)
                 .clamp_min(-1.0))


def accepted(ok) -> np.ndarray:
    """Each row's share of accepted samples, float64 ``[R]``."""
    if not on_card(ok):
        return _host(ok).mean(1)
    _to_card(ok)
    return _host(ok.sum(1)) / ok.shape[1]
