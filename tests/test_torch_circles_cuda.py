"""The pre-check's circle fit kernel (``csrc/circles.cu``) against the
plain numpy fit, on a card.

Imports no jax; on a machine without JAX leave out ``tests/conftest.py``:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_circles_cuda.py -q

Every comparison is of bits: the kernel path of ``fit_circles`` and
``reach_at`` against their plain route (``fit_circles`` on CPU copies,
with ``reach_plain`` and ``pick_plain``; ``reach_at_plain``) on the same
cover traces, made on the card as the compile makes them, the ``pick``
entry against ``pick_plain``, and a compile on the card against the same
compile with both dispatchers sent to the plain route, and with the
pre-check's reductions (``ops/precheck_reduce``) sent there too; and a
compile and a call that wait on the card only in ``profiling.readback``.
Without a card each test skips: the kernel has no CPU mode.
"""

import dataclasses

import numpy as np
import pytest
import torch
from _circles_cases import planted

from torch.profiler import ProfilerActivity, profile

import zoic_tpu_torch as zpt
from zoic_tpu_torch import pupil as tp
from zoic_tpu_torch.ops import circles_kernel as ck
from zoic_tpu_torch.ops import precheck_reduce as pr
from zoic_tpu_torch.utils import profiling

COMPILE_N = 50_000
FIT = ck.fit_circles


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _bits(*arrays):
    return [np.asarray(a, np.float64).view(np.int64) for a in arrays]


def _assert_bits_equal(got, want):
    for g, w in zip(_bits(*got), _bits(*want)):
        np.testing.assert_array_equal(g, w)


def _covers(camera: str, n: int, dev):
    """The fit cover of a shipped camera as the compile traces it: the
    compile's keys and domain, ``n`` samples a key, uniforms from a
    generator on the card."""
    cam = zpt.data.CAMERAS[camera]
    lens = zpt.load_state(zpt.data.state_path(camera), device=dev).lens
    keys = (lens.lut.keys if lens.lut is not None
            else torch.arange(32, dtype=torch.float32, device=dev)
            * tp.f32(tp.FILM_WIDTH / 32))
    g = torch.Generator(device=dev).manual_seed(len(camera) * 7919 + n)
    u = torch.rand((2, keys.shape[0], n), generator=g, device=dev)
    domain = "square" if cam.use_image else "disk"
    lx, ly, ok = tp._cover_trace(lens, keys, u, domain)
    return lx.contiguous(), ly.contiguous(), ok.contiguous()


def _check_fit(lx, ly, ok):
    before = ck.launches
    got = ck.fit_circles(lx, ly, ok)
    assert ck.launches == before + 2
    _assert_bits_equal(got, FIT(lx.cpu(), ly.cpu(), ok.cpu()))
    # the smoothing loop's reach at moved centres, a key's own pair
    a1, _, a2, _ = got
    rng = np.random.default_rng(lx.shape[1])
    centres = np.stack([a1, a2], 1) + rng.uniform(-0.05, 0.05, (a1.size, 2))
    m2 = ck.reach_at(lx, ly, ok, centres)
    assert ck.launches == before + 3
    _assert_bits_equal([m2], [ck.reach_at_plain(lx, ly, ok, centres)])
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("camera", list(zpt.data.CAMERAS))
def test_fit_matches_numpy_on_compile_covers(cuda_dev, camera):
    """Every shipped camera's fit cover at the compile's 50,000 samples a
    key (the pick's stride 4)."""
    lx, ly, ok = _covers(camera, COMPILE_N, cuda_dev)
    _check_fit(lx, ly, ok)


@pytest.mark.cuda
def test_fit_matches_numpy_at_stride_one(cuda_dev):
    lx, ly, ok = _covers("headline", 4096, cuda_dev)
    _check_fit(lx, ly, ok)


@pytest.mark.cuda
@pytest.mark.parametrize("n_keys,n", [(6, 4096), (5, 50_000), (40, 30_001),
                                      (5, 100_000)])
def test_fit_matches_numpy_on_planted_keys(cuda_dev, n_keys, n):
    """A key with no accepted sample keeps (0, -1, 0, -1); a key with every
    sample accepted; a key whose pairs all tie takes the first, (-3, 0)."""
    lx, ly, ok = (torch.from_numpy(a).to(cuda_dev)
                  for a in planted(n_keys, n, seed=n))
    a1, q1, a2, q2 = _check_fit(lx, ly, ok)
    assert (a1[1], q1[1], a2[1], q2[1]) == (0.0, -1.0, 0.0, -1.0)
    assert (a1[3], a2[3]) == (-3.0, 0.0)


@pytest.mark.cuda
def test_pick_ties_and_counts(cuda_dev):
    """Circles that hold every sample: every pair counts the whole
    subsample and the first flat index wins; circles that hold none count
    0 at flat index 0 too; at the fit's own radii, count and index are
    ``pick_plain``'s."""
    lx, ly, ok = (torch.from_numpy(a).to(cuda_dev)
                  for a in planted(6, 50_000, seed=2))
    cand = np.linspace(-3.0, 3.0, ck.CIRCLE_CENTERS)
    negi, posi = np.where(cand <= 0.0)[0], np.where(cand >= 0.0)[0]
    for rk2, want in ((np.full((6, cand.size), 100.0), 12_500),
                      (np.full((6, cand.size), -1.0), 0)):
        count, flat = ck.pick(lx, ly, rk2, cand, negi, posi, 4)
        assert (count == want).all() and (flat == 0).all()
    m2 = ck.reach(lx, ly, ok, torch.from_numpy(cand).to(cuda_dev))
    rk2 = (np.sqrt(np.maximum(m2, 0.0)) * 1.01 + 0.005) ** 2
    for g, w in zip(ck.pick(lx, ly, rk2, cand, negi, posi, 4),
                    ck.pick_plain(lx, ly, rk2, cand, negi, posi, 4)):
        np.testing.assert_array_equal(g, w)


def _numpy_dispatch(monkeypatch):
    """Both dispatchers of the compile sent to the plain route."""
    monkeypatch.setattr(ck, "fit_circles", lambda lx, ly, ok: (
        FIT(lx.cpu(), ly.cpu(), ok.cpu())))
    monkeypatch.setattr(ck, "reach_at", ck.reach_at_plain)


@pytest.mark.cuda
@pytest.mark.parametrize("camera", list(zpt.data.CAMERAS))
def test_compile_on_card_equals_numpy_fit(cuda_dev, camera, monkeypatch,
                                          tmp_path):
    """A camera compiled on the card with the kernel has the bits of the
    same compile (same draws) with the fit in numpy: the profile's chains,
    its polynomial and scale, the form, the poly flag and the dead film.
    Three launches a compile with the LUT (the fit's reach and pick, the
    smoothing's reach), two without it."""
    cam = zpt.data.CAMERAS[camera]
    bokeh = tmp_path / "disk64.npy"
    np.save(bokeh, zpt.data.bokeh_disk(64))
    cfg = zpt.CameraConfig(lens_model=zpt.LensModel.RAYTRACED,
                           lens_data_path=zpt.data.lens_path(cam.lens),
                           bokeh_path=str(bokeh) if cam.use_image else "",
                           **cam.config_kwargs())
    before = ck.launches
    got = zpt.compile_camera(cfg, cuda_dev).lens
    assert ck.launches == before + (3 if cam.kolb_sampling_lut else 2)
    _numpy_dispatch(monkeypatch)
    want = zpt.compile_camera(cfg, cuda_dev).lens
    assert ck.launches == before + (3 if cam.kolb_sampling_lut else 2)
    for f in ("profile_domain", "profile_poly", "dead_frac"):
        assert getattr(got, f) == getattr(want, f), f
    gp, wp = got.profile, want.profile
    assert gp.kind == wp.kind
    for f in ("keys", "c0", "c1", "c2", "c4", "poly", "poly_scale"):
        g, w = getattr(gp, f), getattr(wp, f)
        assert g.is_cuda and torch.equal(g.view(torch.int32),
                                         w.view(torch.int32)), f
    assert dataclasses.is_dataclass(gp)


def _camera_config(camera, tmp_path, focus=None):
    cam = zpt.data.CAMERAS[camera]
    bokeh = tmp_path / "disk64.npy"
    np.save(bokeh, zpt.data.bokeh_disk(64))
    cfg = zpt.CameraConfig(lens_model=zpt.LensModel.RAYTRACED,
                           lens_data_path=zpt.data.lens_path(cam.lens),
                           bokeh_path=str(bokeh) if cam.use_image else "",
                           **cam.config_kwargs())
    return cfg if focus is None else cfg.replace(focal_distance=focus)


@pytest.mark.cuda
@pytest.mark.parametrize("focus", [None, 1000.0])
@pytest.mark.parametrize("camera", list(zpt.data.CAMERAS))
def test_compile_on_card_equals_numpy_precheck(cuda_dev, camera, focus,
                                               monkeypatch, tmp_path):
    """A camera compiled on the card, at its own focus and at 1000 cm, with
    the pre-check's reductions on the card (``ops/precheck_reduce``: 9
    calls a compile, 12 where the circle poly is fitted) has the bits of
    the same compile with them, the circle fit and the smoothing's reach
    all in numpy: the profile's chains, polynomial and scale, the form,
    the poly flag and the dead film.  The host's trig opens its span
    ``zoic.precheck.trig`` once a compile."""
    cfg = _camera_config(camera, tmp_path, focus)
    before = pr.calls
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = zpt.compile_camera(cfg, cuda_dev).lens
    assert pr.calls - before in (9, 12)
    assert [e.name for e in prof.events()].count("zoic.precheck.trig") == 1
    after = pr.calls
    want = _numpy_precheck(cfg, cuda_dev, monkeypatch)
    assert pr.calls == after
    _assert_same_precheck(got, want)


def _numpy_precheck(cfg, dev, monkeypatch):
    """The compile of ``cfg`` with the circle fit, the smoothing's reach and
    the pre-check's reductions all in numpy."""
    _numpy_dispatch(monkeypatch)
    monkeypatch.setattr(pr, "on_card", lambda t: False)
    return zpt.compile_camera(cfg, dev).lens


def _assert_same_precheck(got, want):
    """The profile's chains, polynomial and scale, the form, the poly flag
    and the dead film, bit for bit."""
    for f in ("profile_domain", "profile_poly", "dead_frac"):
        assert getattr(got, f) == getattr(want, f), f
    gp, wp = got.profile, want.profile
    assert gp.kind == wp.kind
    for f in ("keys", "c0", "c1", "c2", "c4", "poly", "poly_scale"):
        g, w = getattr(gp, f), getattr(wp, f)
        assert g.is_cuda and torch.equal(g.view(torch.int32),
                                         w.view(torch.int32)), f


@pytest.mark.cuda
@pytest.mark.parametrize("camera", list(zpt.data.CAMERAS))
def test_the_compile_waits_on_the_card_only_in_its_readbacks(
        cuda_dev, camera, monkeypatch, tmp_path):
    """A camera compiled and called once under ``torch.cuda``'s sync-debug
    mode ``"error"``, which ``profiling.readback`` alone lifts: no copy of
    the compile or of the raytraced wrapper's table build waits on the card
    outside it (the uploads do not wait).  The clock counts those
    read-backs, and the state has the bits of the numpy route's."""
    cfg = _camera_config(camera, tmp_path)
    u = torch.rand((4, 4096), generator=torch.Generator().manual_seed(5))
    sx, sy, lx, ly = (u[0] * 2 - 1).to(cuda_dev), (u[1] * 2 - 1).to(
        cuda_dev), u[2].to(cuda_dev), u[3].to(cuda_dev)
    torch.cuda.synchronize()
    profiling.clock_reset()
    torch.cuda.set_sync_debug_mode("error")
    try:
        cam = zpt.Camera(cfg, cuda_dev)
        rays, _ = cam.create_rays(sx, sy, lx, ly, seed=7)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert rays.weight.shape == (4096,)
    spans = profiling.clock_report()["spans"]
    reads = {p: r for (p, traced), r in spans.items()
             if p.endswith("/" + profiling.READBACK)}
    assert reads and all(r["bytes"] > 0 for r in reads.values())
    assert "zoic.compile/zoic.compile.precheck/zoic.precheck.covers/" \
        + profiling.READBACK in reads
    assert "zoic.tables.build/" + profiling.READBACK in reads
    _assert_same_precheck(cam.state.lens,
                          _numpy_precheck(cfg, cuda_dev, monkeypatch))
