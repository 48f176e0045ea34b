"""The pre-check's reductions on the card (``ops/precheck_reduce``), on the
CPU.

``pupil.build_precheck`` keeps numpy's ``arctan2`` and ``cos`` on the host
and hands the reductions over the cover samples (the harmonic bins'
maxima, the held-out and midpoint violations, the pick's pass shares, the
circle poly's requirement) to ``ops/precheck_reduce``, which runs them in
PyTorch for CUDA tensors and in numpy (the ``*_plain`` versions, the JAX
package's expressions) otherwise.  Here the PyTorch route runs on CPU
tensors (``on_card`` made to say yes for any tensor) and must give the
plain route's bits: each reduction on planted keys, and the whole
pre-check on four shipped cameras (the LUT and the naive cover, both
domains, both forms) with planted keys in every cover set.  The route on
the card itself: ``tests/test_torch_circles_cuda.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch
from _circles_cases import planted
from _torch_threads import one_thread  # noqa: F401

import zoic_tpu_torch as zpt
from zoic_tpu_torch import pupil as tp
from zoic_tpu_torch.ops import precheck_reduce as pr

R_MAX = 3.6 * 0.5 * np.sqrt(2.0)


def _torch_route(monkeypatch):
    """The PyTorch route for every tensor, CPU tensors included."""
    monkeypatch.setattr(pr, "on_card",
                        lambda t: isinstance(t, torch.Tensor))


@pytest.fixture
def torch_route(monkeypatch):
    _torch_route(monkeypatch)


def _bits(a):
    a = np.asarray(a)
    return a.view({8: np.int64, 4: np.int32}[a.itemsize])


def _same(got, want):
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_each_reduction_is_its_plain_version(torch_route):
    """On planted keys (1 accepts nothing, 2 everything, 3 all at the
    origin, 4 the left half): every reduction's bits, and row 0's
    harmonic excess and circle violation exactly 0 on both routes."""
    n_keys, n = 8, 4096
    lxn, lyn, okn = planted(n_keys, n, seed=5)
    lx, ly, ok = (torch.from_numpy(a) for a in (lxn, lyn, okn))
    rng = np.random.default_rng(5)
    cos = tp._cosines(lxn, lyn)
    cos_t = pr.routed(cos, lx)
    assert isinstance(cos_t, torch.Tensor)
    coef = rng.uniform(-0.3, 1.0, (4, n_keys))
    # row 0: the bound is the largest accepted rho, so the excess is 0
    rho0 = np.sqrt(lxn[0] * lxn[0] + lyn[0] * lyn[0])[okn[0]].max()
    coef[:, 0] = (rho0, 0.0, 0.0, 0.0)
    two_a = rng.uniform(-2.0, 2.0, (n_keys, 2))
    q = rng.uniform(0.0, 2.0, (n_keys, 2))
    phi = np.arctan2(lyn, lxn)
    bins = np.clip(((phi + np.pi) / (2 * np.pi) * 16).astype(np.int64), 0, 15)
    before = pr.calls
    pairs = [
        (pr.bin_max(lx, ly, ok, bins, 16),
         pr.bin_max_plain(lxn, lyn, okn, bins, 16)),
        (pr.harmonic_excess(lx, ly, ok, cos_t, coef),
         pr.harmonic_excess_plain(lxn, lyn, okn, cos, coef)),
        (pr.harmonic_share(lx, ly, cos_t, coef),
         pr.harmonic_share_plain(lxn, lyn, cos, coef)),
        (pr.circle_excess(lx, ly, ok, two_a),
         pr.circle_excess_plain(lxn, lyn, okn, two_a)),
        (pr.circle_share(lx, ly, two_a, q),
         pr.circle_share_plain(lxn, lyn, two_a, q)),
        (pr.circle_reach(lx, ly, ok, two_a),
         pr.circle_reach(lxn, lyn, okn, two_a)),
        (pr.accepted(ok), pr.accepted(okn)),
    ]
    assert pr.calls == before + 7
    for got, want in pairs:
        _same(got, want)
    (m, _), (h, _), _, (t, _), _, (r, _), (acc, _) = pairs
    assert (m[1] == 0.0).all() and (m[3] == 0.0).all() and m[2].min() > 0.0
    assert h[0] == 0.0 and h[1] == -np.inf
    assert (t[1] == -np.inf).all() and (r[1] == -1.0).all()
    assert (acc[1], acc[2], acc[3]) == (0.0, 1.0, 1.0)
    # a violation of exactly 0 loosens nothing, on both routes
    a = two_a / 2.0
    q0 = q.copy()
    q0[0] = t[0]
    for lxs, lys, oks in ((lx, ly, ok), (lxn, lyn, okn)):
        v1, v2 = tp._circle_viol(a[:, 0], q0[:, 0], a[:, 1], q0[:, 1],
                                 lxs, lys, oks)
        assert (v1[0], v2[0]) == (0.0, 0.0) and (v1[1], v2[1]) == (0.0, 0.0)


def _planted_covers(monkeypatch):
    """Each cover trace as the compile makes it, then planted: the fit
    set's last key accepts nothing (the reject-all chain; it lies over
    ``R_MAX``, so the circle poly still fits), key 5 accepts no held-out
    or midpoint sample, key 7 accepts every sample of every set."""
    real = tp._cover_trace
    calls = []

    def trace(lens, radii, u, domain):
        lx, ly, ok = real(lens, radii, u, domain)
        ok = ok.clone()
        if len(calls) % 3 == 0:     # the fit set of each build
            ok[-1] = False
        else:
            ok[5] = False
        ok[7] = True
        calls.append(domain)
        return lx, ly, ok

    monkeypatch.setattr(tp, "_cover_trace", trace)


@pytest.mark.parametrize("camera", ["headline", "raytraced_bokeh_image",
                                    "raytraced_naive", "raytraced_fisheye"])
def test_build_precheck_card_route_on_cpu(monkeypatch, camera):
    """The pre-check with its reductions in PyTorch gives the plain
    route's profile bit for bit: form, chains, poly and scale, key
    acceptance and deficit (circles on the Double Gauss, disk and square;
    the naive cover and the fisheye take the harmonic form)."""
    cam = zpt.data.CAMERAS[camera]
    lens = dataclasses.replace(
        zpt.load_state(zpt.data.state_path(camera), device="cpu").lens,
        profile=None)
    domain = "square" if cam.use_image else "disk"
    n = 1024
    rng = np.random.default_rng(len(camera))
    uni = {"cover_fit": rng.uniform(0, 1, (2, 32, n)),
           "cover_held": rng.uniform(0, 1, (2, 32, n)),
           "cover_mid": rng.uniform(0, 1, (2, 31, n // 2))}
    _planted_covers(monkeypatch)
    before = pr.calls
    want = tp.build_precheck(lens, n, domain=domain, r_max=R_MAX,
                             uniforms=uni)
    assert pr.calls == before
    _torch_route(monkeypatch)
    got = tp.build_precheck(lens, n, domain=domain, r_max=R_MAX, uniforms=uni)
    (gp, gacc, gdef), (wp, wacc, wdef) = got, want
    circles = wp.kind == "circles"
    # accepted x2, bin maxima, two excesses a form, two shares, and the
    # circle poly's three reaches
    assert pr.calls == before + (12 if circles else 9)
    assert gp.kind == wp.kind == ("circles" if camera in (
        "headline", "raytraced_bokeh_image") else "harmonic")
    assert np.isfinite(wdef) and _bits(gdef) == _bits(wdef)
    _same(gacc.numpy(), wacc.numpy())
    assert (wacc[-1], wacc[7]) == (0.0, 1.0)
    for f in ("c0", "c1", "c2", "c4", "poly", "poly_scale"):
        _same(getattr(gp, f).numpy(), getattr(wp, f).numpy())
