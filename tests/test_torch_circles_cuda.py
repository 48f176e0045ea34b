"""The pre-check's circle fit kernel (``csrc/circles.cu``) against the
plain numpy fit, on a card.

Imports no jax; on a machine without JAX leave out ``tests/conftest.py``:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_circles_cuda.py -q

Every comparison is of bits: the kernel path of ``fit_circles`` and
``reach_at`` against ``pupil._fit_circles_np`` and ``pupil._reach_np`` on
the same cover traces, made on the card as the compile makes them, and a
compile on the card against the same compile with both dispatchers sent
to the numpy.  Without a card each test skips: the kernel has no CPU mode.
"""

import dataclasses

import numpy as np
import pytest
import torch
from _circles_cases import planted

import zoic_tpu_torch as zpt
from zoic_tpu_torch import pupil as tp
from zoic_tpu_torch.ops import circles_kernel as ck

COMPILE_N = 50_000


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _np(t):
    return t.cpu().numpy()


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
    _assert_bits_equal(got, tp._fit_circles_np(_np(lx), _np(ly), _np(ok)))
    # the smoothing loop's reach at moved centres, a key's own pair
    a1, _, a2, _ = got
    rng = np.random.default_rng(lx.shape[1])
    centres = np.stack([a1, a2], 1) + rng.uniform(-0.05, 0.05, (a1.size, 2))
    m2 = ck.reach_at(lx, ly, ok, centres)
    assert ck.launches == before + 3
    _assert_bits_equal([m2], [tp._reach_np(_np(lx), _np(ly), _np(ok),
                                           centres)])
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
    0 at flat index 0 too."""
    lx, ly, _ = (torch.from_numpy(a).to(cuda_dev)
                 for a in planted(6, 50_000, seed=2))
    cand = np.linspace(-3.0, 3.0, tp._CIRCLE_CENTERS)
    negi, posi = np.where(cand <= 0.0)[0], np.where(cand >= 0.0)[0]
    for rk2, want in ((np.full((6, cand.size), 100.0), 12_500),
                      (np.full((6, cand.size), -1.0), 0)):
        count, flat = ck.pick(lx, ly, rk2, cand, negi, posi, 4)
        assert (count == want).all() and (flat == 0).all()


def _numpy_dispatch(monkeypatch):
    """Both dispatchers of the compile sent to the plain numpy."""
    monkeypatch.setattr(ck, "fit_circles", lambda lx, ly, ok: (
        tp._fit_circles_np(_np(lx), _np(ly), _np(ok))))
    monkeypatch.setattr(ck, "reach_at", lambda lx, ly, ok, c: (
        tp._reach_np(_np(lx), _np(ly), _np(ok), c)))


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
