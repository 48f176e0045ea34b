"""The pre-check's circle fit around its CUDA kernel, on the CPU.

``ops/circles_kernel.fit_circles`` and ``reach_at`` run the plain numpy
(``pupil._fit_circles_np``, ``pupil._reach_np``) for CPU tensors and never
launch.  The host steps of the card path (``_fit_on_card``: the radii,
their squares, the pair's indices, ``q``, the reject-all keys) are held to
the plain fit bit for bit with the two kernel entries written out here in
numpy as ``csrc/circles.cu`` defines them: the reach as a max of
``fl64(d * d) + fl64(fl32(py * py))``, the pick as the least (count, flat
index) of integer joint counts.  The kernel itself is held to the plain
fit on the card (``tests/test_torch_circles_cuda.py``).
"""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch
from _circles_cases import planted
from _torch_threads import one_thread  # noqa: F401

import zoic_tpu_torch as zpt
from zoic_tpu_torch import pupil as tp
from zoic_tpu_torch.ops import _build
from zoic_tpu_torch.ops import circles_kernel as ck

R_MAX = 3.6 * 0.5 * np.sqrt(2.0)


def _reach_written_out(lx, ly, ok, centres):
    lxn, lyn, okn = lx.numpy(), ly.numpy(), ok.numpy()
    cen = np.broadcast_to(centres.numpy(), (lxn.shape[0], centres.shape[-1]))
    m2 = np.full(cen.shape, -1.0)
    for k in range(lxn.shape[0]):
        if okn[k].any():
            px = lxn[k][okn[k]].astype(np.float64)
            py = lyn[k][okn[k]]
            d = px[:, None] - cen[k][None, :]
            m2[k] = (d * d + (py * py).astype(np.float64)[:, None]).max(0)
    return m2


def _pick_written_out(lx, ly, rk2, cand, negi, posi, stride):
    lxn, lyn = lx.numpy(), ly.numpy()
    count = np.empty(lxn.shape[0], np.int64)
    flat = np.empty(lxn.shape[0], np.int64)
    for k in range(lxn.shape[0]):
        sx = lxn[k][::stride].astype(np.float64)
        sy = lyn[k][::stride]
        d = sx[:, None] - cand[None, :]
        inside = (d * d + (sy * sy).astype(np.float64)[:, None]
                  <= rk2[k][None, :]).astype(np.int64)
        joint = (inside[:, negi].T @ inside[:, posi]).ravel()
        f = int(np.flatnonzero(joint == joint.min())[0])
        count[k], flat[k] = joint[f], f
    return count, flat


def _card_path_written_out(monkeypatch):
    """The card path of both dispatchers, with the kernel's two entries
    written out in numpy."""
    monkeypatch.setattr(ck, "reach", _reach_written_out)
    monkeypatch.setattr(ck, "pick", _pick_written_out)
    monkeypatch.setattr(ck, "fit_circles", ck._fit_on_card)
    monkeypatch.setattr(
        ck, "reach_at",
        lambda lx, ly, ok, c: ck.reach(lx, ly, ok, torch.from_numpy(c)))


@pytest.fixture
def written_out_entries(monkeypatch):
    _card_path_written_out(monkeypatch)


def _bits(*arrays):
    return [np.asarray(a, np.float64).view(np.int64) for a in arrays]


def _tensors(n_keys, n, seed):
    return tuple(torch.from_numpy(a) for a in planted(n_keys, n, seed))


@pytest.mark.parametrize("n_keys,n", [(6, 4096), (5, 50_000)])
def test_fit_circles_on_cpu_is_the_plain_fit(n_keys, n):
    lx, ly, ok = _tensors(n_keys, n, seed=n)
    before = ck.launches
    got = ck.fit_circles(lx, ly, ok)
    want = tp._fit_circles_np(lx.numpy(), ly.numpy(), ok.numpy())
    assert ck.launches == before
    for g, w in zip(_bits(*got), _bits(*want)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n_keys,n", [(6, 4096), (5, 50_000), (8, 30_001)])
def test_card_path_host_steps_match_plain_fit(written_out_entries, n_keys, n):
    """Strides 1, 4 and 2; the reject-all key keeps (0, -1), the all-tie key
    picks the first pair."""
    lx, ly, ok = _tensors(n_keys, n, seed=n + 1)
    got = ck._fit_on_card(lx, ly, ok)
    want = tp._fit_circles_np(lx.numpy(), ly.numpy(), ok.numpy())
    for g, w in zip(_bits(*got), _bits(*want)):
        np.testing.assert_array_equal(g, w)
    a1, q1, a2, q2 = got
    assert (a1[1], q1[1], a2[1], q2[1]) == (0.0, -1.0, 0.0, -1.0)
    assert (a1[3], a2[3]) == (-3.0, 0.0)
    assert (q1 > -1.0).sum() == n_keys - 1


def test_pick_written_out_breaks_ties_at_the_first_index():
    lx, ly, ok = _tensors(6, 4096, seed=3)
    cand = np.linspace(-3.0, 3.0, tp._CIRCLE_CENTERS)
    negi, posi = np.where(cand <= 0.0)[0], np.where(cand >= 0.0)[0]
    rk2 = np.full((6, cand.size), 100.0)  # every circle holds every sample
    count, flat = _pick_written_out(lx, ly, rk2, cand, negi, posi, 1)
    assert (count == 4096).all() and (flat == 0).all()


def test_reach_at_on_cpu_is_the_smoothing_loop():
    """``pupil._reach_np`` gives what the smoothing loop computed inline
    before, and -1 on the key with no accepted sample; no launch."""
    lx, ly, ok = _tensors(6, 4096, seed=7)
    rng = np.random.default_rng(7)
    centres = np.stack([rng.uniform(-3, 0, 6), rng.uniform(0, 3, 6)], 1)
    before = ck.launches
    m2 = ck.reach_at(lx, ly, ok, centres)
    assert ck.launches == before
    lxn, lyn, okn = lx.numpy(), ly.numpy(), ok.numpy()
    for k in range(6):
        if not okn[k].any():
            assert (m2[k] == -1.0).all()
            continue
        px, py = lxn[k][okn[k]], lyn[k][okn[k]]
        for j in range(2):
            inline = ((px - centres[k, j]) ** 2 + py**2).max()
            assert m2[k, j].view(np.int64) == np.float64(inline).view(np.int64)
    np.testing.assert_array_equal(
        _bits(m2)[0],
        _bits(_reach_written_out(lx, ly, ok, torch.from_numpy(centres)))[0])


def test_entries_refuse_cpu_tensors():
    """The entries launch or raise: no numpy fallback inside them."""
    lx, ly, ok = _tensors(6, 64, seed=1)
    cand = np.linspace(-3.0, 3.0, 241)
    before = ck.launches
    with pytest.raises(ValueError, match="CUDA"):
        ck.reach(lx, ly, ok, torch.from_numpy(cand))
    with pytest.raises(ValueError, match="CUDA"):
        ck.pick(lx, ly, np.zeros((6, 241)), cand, np.arange(121),
                np.arange(120, 241), 1)
    assert ck.launches == before


@pytest.mark.parametrize("domain", ["disk", "square"])
def test_build_precheck_card_path_on_cpu(monkeypatch, domain):
    """``build_precheck`` through the card path's host steps gives the plain
    build's profile bit for bit, on the headline's LUT at 4,096 samples."""
    st = zpt.load_state(zpt.data.state_path(), device="cpu")
    lens = dataclasses.replace(st.lens, profile=None)
    rng = np.random.default_rng(11)
    n = 4096
    uni = {"cover_fit": rng.uniform(0, 1, (2, 32, n)),
           "cover_held": rng.uniform(0, 1, (2, 32, n)),
           "cover_mid": rng.uniform(0, 1, (2, 31, n // 2))}
    before = ck.launches
    want = tp.build_precheck(lens, n, domain=domain, r_max=R_MAX, uniforms=uni)
    assert ck.launches == before
    _card_path_written_out(monkeypatch)
    got = tp.build_precheck(lens, n, domain=domain, r_max=R_MAX, uniforms=uni)
    (gp, gacc, gdef), (wp, wacc, wdef) = got, want
    assert gp.kind == wp.kind and gdef == wdef
    np.testing.assert_array_equal(gacc.numpy(), wacc.numpy())
    for f in ("c0", "c1", "c2", "c4", "poly", "poly_scale"):
        np.testing.assert_array_equal(getattr(gp, f).numpy().view(np.int32),
                                      getattr(wp, f).numpy().view(np.int32),
                                      err_msg=f)


def _viol_masked(a1, q1, a2, q2, lxn, lyn, okn):
    rr = lxn * lxn + lyn * lyn
    v1 = np.where(okn, rr - 2.0 * a1[:, None] * lxn - q1[:, None], -np.inf)
    v2 = np.where(okn, rr - 2.0 * a2[:, None] * lxn - q2[:, None], -np.inf)
    return np.maximum(v1.max(1), 0.0), np.maximum(v2.max(1), 0.0)


@pytest.mark.parametrize("seed", [0, 1])
def test_circle_viol_is_the_masked_form(seed):
    """``_circle_viol`` over each key's accepted samples, ``q`` subtracted
    after the max, gives the masked ``[keys, samples]`` form's bits: keys
    with no sample, with none outside and with some outside the circles."""
    lx, ly, ok = planted(8, 20_000, seed)
    rng = np.random.default_rng(seed)
    a1, a2 = rng.uniform(-1.0, 0.0, 8), rng.uniform(0.0, 1.0, 8)
    q1, q2 = rng.uniform(0.0, 3.0, 8), rng.uniform(0.0, 3.0, 8)
    got = tp._circle_viol(a1, q1, a2, q2, lx, ly, ok)
    want = _viol_masked(a1, q1, a2, q2, lx, ly, ok)
    for g, w in zip(_bits(*got), _bits(*want)):
        np.testing.assert_array_equal(g, w)
    assert (got[0] == 0.0).any() and (got[0] > 0.0).any()


def test_source_constants_match_the_wrapper():
    with open(os.path.join(_build.CSRC, "circles.cu")) as f:
        src = f.read()
    block = int(re.search(r"constexpr int kReachBlock = (\d+);", src)[1])
    assert block == ck.MAX_CENTRES
    assert "--fmad=false" in _build.NVCC_FLAGS
