"""The port's exact eager path against the JAX package's, on the CPU.

The eager path (``impl="jnp"``, any batch shape) is the
reference's per-ray code as tensor ops: ``sampling.concentric_disk_sample``,
``models.common.aperture_sample`` / ``resample_rounds``, the eager branches
of both models and the pupil functions off the compile path.  The JAX side
runs its own eager path (``impl="jnp"``) op by op with XLA's ``rsqrt``
taken as ``1 / sqrt`` and its float32 ``cos``/``sin`` as the float64 ones
rounded, the port's definitions (``tests/test_torch_trace_pupil.py``);
never its interpret-mode kernels.  Inputs come from numpy with a seed and
both packages read the same shipped states.  Gates:

* the concentric map bit-equal, corner cases included;
* ``resample_rounds`` by distribution, as ``tests/test_retry_semantics.py``
  holds the JAX package's (its draws come from a ``torch.Generator``);
* the first attempt (``max_tries=0``: weight > 0 iff it succeeded): ok
  masks equal (the fisheye's last-bit iris hits under 0.5%), payloads of
  rays alive in both within 1e-5, against JAX and against the port's plain
  kernel path; at the full budget the kernel path's attempts/ray and
  vignetted fraction;
* ``impl="jnp"`` never reaches a kernel wrapper, and an ``[H, W]`` batch
  runs the kernel (flattened) or, with ``impl="jnp"``, the eager path.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zoic_tpu as jt
from zoic_tpu import pupil as jp
from zoic_tpu import sampling as js
from zoic_tpu.io import state as jax_state_io

import zoic_tpu_torch as zpt
from zoic_tpu_torch import pupil as tp
from zoic_tpu_torch import sampling as ts
from zoic_tpu_torch.models import common
from zoic_tpu_torch.ops import trace_kernel as tk
from _torch_threads import one_thread  # noqa: F401

N = 2_125
ATOL = 1e-5
# the fisheye's iris (R = 1e4 cm in a 1 cm lens) is hit in the last bit
MASK_FLIPS = {"headline": 0.0, "raytraced_fisheye": 0.005}


def _f64_trig(fn):
    def f(x):
        if getattr(x, "dtype", None) == jnp.float32:
            return jnp.asarray(fn(np.asarray(x, np.float64)).astype(np.float32))
        return fn(x)
    return f


@pytest.fixture
def op_by_op(monkeypatch):
    monkeypatch.setattr(jax.lax, "rsqrt", lambda x: 1.0 / jnp.sqrt(x))
    monkeypatch.setattr(jnp, "cos", _f64_trig(np.cos))
    monkeypatch.setattr(jnp, "sin", _f64_trig(np.sin))
    with jax.disable_jit():
        yield


@pytest.fixture(scope="module")
def states():
    """Shipped states read by both packages' loaders."""
    out = {}
    for cam in MASK_FLIPS:
        path = zpt.data.state_path(cam)
        out[cam] = (jax_state_io.load(path), zpt.load_state(path, device="cpu"))
    return out


def _samples(n, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, n).astype(np.float32),
            rng.uniform(-1, 1, n).astype(np.float32),
            rng.uniform(0, 1, n).astype(np.float32),
            rng.uniform(0, 1, n).astype(np.float32)]


def _raytraced_cfgs(camera, **kw):
    c = zpt.data.CAMERAS[camera]
    kwargs = dict(c.config_kwargs(), **kw)
    return (jt.CameraConfig(lens_model=jt.LensModel.RAYTRACED,
                            lens_data_path=jt.data.lens_path(c.lens),
                            impl="jnp", **kwargs),
            zpt.CameraConfig(lens_model=zpt.LensModel.RAYTRACED,
                             lens_data_path=zpt.data.lens_path(c.lens),
                             impl="jnp", **kwargs))


def _first_attempt_gate(jw, jo, jd, tw, to, td, flips=0.0):
    jok, tok = np.asarray(jw) > 0, tw.numpy() > 0
    assert (jok != tok).sum() <= flips * jok.size
    both = jok & tok
    assert both.sum() > jok.size // 4
    for g, r in ((to, jo), (td, jd)):
        np.testing.assert_allclose(g.numpy()[both], np.asarray(r)[both],
                                   rtol=0, atol=ATOL)


# ---------------------------------------------------------------- sampling

def test_concentric_disk_sample_bit_equal_random(op_by_op):
    u = np.random.default_rng(7).uniform(size=(2, 4096)).astype(np.float32)
    jx, jy = js.concentric_disk_sample(jnp.asarray(u[0]), jnp.asarray(u[1]))
    tx, ty = ts.concentric_disk_sample(torch.from_numpy(u[0]),
                                       torch.from_numpy(u[1]))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    r = np.hypot(tx.numpy(), ty.numpy())
    assert r.max() < 1.01  # the fastSin/fastCos warp


def test_concentric_disk_sample_corner_cases(op_by_op):
    """The centre (the reference's 0 * NaN) maps to (0, 0), the square's
    corners to the disk's edge, and b == 0 takes the guarded branch."""
    u = np.array([0.5, 1.0, 0.0, 1.0, 0.0, 0.5, 0.75], np.float32)
    v = np.array([0.5, 1.0, 0.0, 0.0, 1.0, 0.25, 0.5], np.float32)
    jx, jy = js.concentric_disk_sample(jnp.asarray(u), jnp.asarray(v))
    tx, ty = ts.concentric_disk_sample(torch.from_numpy(u),
                                       torch.from_numpy(v))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    assert tx[0] == 0.0 and ty[0] == 0.0
    np.testing.assert_allclose(np.hypot(tx.numpy(), ty.numpy())[1:5], 1.0,
                               atol=5e-3)
    assert np.isfinite(tx.numpy()).all() and np.isfinite(ty.numpy()).all()


# ------------------------------------------------------ resample_rounds

def _run_batched(p_accept, n, max_tries, seed):
    """resample_rounds on a synthetic Bernoulli acceptance test."""
    g = torch.Generator().manual_seed(seed)
    u0 = torch.rand(n, generator=g)
    zero = torch.zeros((), dtype=torch.int32)

    def retry(u, pending):
        return u[0] < p_accept, (u[0],), zero

    ok, (payload,), tries, _ = common.resample_rounds(
        u0 < p_accept, (u0,), retry, g, max_tries, zero)
    weight, _, _ = common.weight_and_stats(tries, max_tries)
    return ok.numpy(), payload.numpy(), tries.numpy(), weight.numpy()


def test_tries_distribution_matches_sequential():
    """P(tries = k) = p (1-p)^k up to max_tries, the rest at max_tries + 1
    and zero-weighted: (1-p)^(max_tries+1)."""
    p, n, max_tries = 0.35, 200_000, 10
    ok, _, tries, weight = _run_batched(p, n, max_tries, seed=0)
    assert tries.min() >= 0 and tries.max() <= max_tries + 1
    for k in [0, 1, 2, 5]:
        assert float(np.mean(tries == k)) == pytest.approx(
            p * (1 - p) ** k, rel=0.05), f"k={k}"
    assert float(np.mean(weight == 0.0)) == pytest.approx(
        (1 - p) ** (max_tries + 1), rel=0.15)


def test_26th_retry_success_still_zero_weight():
    """A ray whose last allowed retry succeeds is vignetted anyway
    (zoic.cpp:1824-1827 tests tries after the loop)."""
    ok, _, tries, weight = _run_batched(0.02, 100_000, 5, seed=1)
    at_budget = tries == 6
    assert at_budget.any() and (ok & at_budget).any()
    assert (weight[at_budget] == 0.0).all()
    assert (weight[~at_budget] == 1.0).all()


def test_max_tries_zero():
    """max_tries=0: one retry round runs, then every pending ray is
    vignetted, so weight > 0 iff the first attempt succeeded."""
    _, _, tries, weight = _run_batched(0.5, 50_000, 0, seed=2)
    np.testing.assert_array_equal(weight > 0, tries == 0)


def test_accepted_sample_distribution_unbiased():
    """Accepted payloads are distributed as (payload | accept): uniforms
    conditioned below p stay uniform on [0, p), retried or not."""
    p = 0.3
    ok, payload, _, _ = _run_batched(p, 200_000, 25, seed=3)
    vals = payload[ok]
    assert ok.mean() > 0.999 and vals.max() < p
    assert float(vals.mean()) == pytest.approx(p / 2, rel=0.02)
    assert float(np.quantile(vals, 0.25)) == pytest.approx(p / 4, rel=0.04)


# ----------------------------------------------------- raytraced, eager

@pytest.mark.parametrize("camera", list(MASK_FLIPS))
def test_raytraced_first_attempt_matches_jax(states, camera, op_by_op):
    js_, ts_ = states[camera]
    jcfg, tcfg = _raytraced_cfgs(camera, max_tries=0)
    s = _samples(N)
    jr, _ = jt.create_rays(js_, jcfg, *(jnp.asarray(a) for a in s),
                           jax.random.PRNGKey(0))
    tr, tstats = zpt.create_rays(ts_, tcfg, *(torch.from_numpy(a) for a in s),
                                 seed=5)
    _first_attempt_gate(jr.weight, jr.origin, jr.dir, tr.weight, tr.origin,
                        tr.dir, MASK_FLIPS[camera])
    assert int(tstats.success) + int(tstats.vignetted) == N


@pytest.mark.parametrize("camera", list(MASK_FLIPS))
def test_raytraced_eager_matches_plain_kernel_path(states, camera):
    _, ts_ = states[camera]
    _, tcfg = _raytraced_cfgs(camera, max_tries=0)
    s = [torch.from_numpy(a) for a in _samples(N, seed=4)]
    er, _ = zpt.create_rays(ts_, tcfg, *s, seed=5)
    kr, _ = zpt.create_rays(ts_, dataclasses.replace(tcfg, impl="auto"), *s,
                            seed=5)
    _first_attempt_gate(kr.weight, kr.origin, kr.dir, er.weight, er.origin,
                        er.dir, MASK_FLIPS[camera])


def test_raytraced_eager_full_budget_matches_kernel_path(states):
    """The eager path traces every try where the kernel path runs the
    pre-check; the pre-check is exact, so the tries' distribution is the
    same: attempts/ray within 3% (4 standard deviations of the difference)
    and the vignetted fraction within 0.5% at 20,000 rays."""
    _, ts_ = states["headline"]
    _, tcfg = _raytraced_cfgs("headline")
    n = 20_000
    s = [torch.from_numpy(a) for a in _samples(n, seed=6)]
    out = [zpt.create_rays(ts_, dataclasses.replace(tcfg, impl=impl), *s,
                           seed=9)[1] for impl in ("jnp", "auto")]
    att = [1.0 + int(st.tries_total) / n for st in out]
    vig = [int(st.vignetted) / n for st in out]
    assert att[0] == pytest.approx(att[1], rel=0.03)
    assert abs(vig[0] - vig[1]) <= 0.005
    assert 1.2 < att[0] < 3.0


# ----------------------------------------------------- thin lens, eager

def _thinlens_cfgs(tmp_path, **kw):
    if kw.pop("bokeh", False):
        path = str(tmp_path / "disk.npy")
        np.save(path, zpt.data.bokeh_disk(32))
        kw.update(use_image=True, bokeh_path=path)
    common_kw = dict(dict(focal_length=5.0, fstop=1.4, focal_distance=100.0,
                          max_tries=0), **kw)
    return (jt.CameraConfig(lens_model=jt.LensModel.THINLENS, impl="jnp",
                            **common_kw),
            zpt.CameraConfig(lens_model=zpt.LensModel.THINLENS, impl="jnp",
                             **common_kw))


@pytest.mark.parametrize("kw", [
    dict(use_dof=False), dict(use_dof=True),
    dict(use_dof=True, optical_vignetting_distance=4.0,
         optical_vignetting_radius=0.6),
    dict(use_dof=True, bokeh=True),
], ids=["pinhole", "dof", "dof_vignetting", "dof_bokeh"])
def test_thinlens_first_attempt_matches_jax(tmp_path, kw, op_by_op):
    jcfg, tcfg = _thinlens_cfgs(tmp_path, **kw)
    jst = jt.compile_camera(jcfg)
    tst = zpt.compile_camera(tcfg, "cpu")
    s = _samples(N, seed=8)
    jr, _ = jt.create_rays(jst, jcfg, *(jnp.asarray(a) for a in s),
                           jax.random.PRNGKey(0))
    tr, _ = zpt.create_rays(tst, tcfg, *(torch.from_numpy(a) for a in s),
                            seed=5)
    _first_attempt_gate(jr.weight, jr.origin, jr.dir, tr.weight, tr.origin,
                        tr.dir)
    if "optical_vignetting_distance" in kw:
        assert (tr.weight.numpy() == 0).any()  # vignetting rejected some


# ------------------------------------------------ dispatch and batch shape

@pytest.mark.parametrize("model", ["raytraced", "thinlens"])
def test_non_flat_batch_runs_the_kernel(states, model, monkeypatch,
                                        tmp_path):
    """An [H, W] batch runs the kernel wrapper once, on the flattened
    samples, and equals the flat kernel call bit for bit in the caller's
    shape (the JAX package sends it to its eager path only because Pallas
    takes flat blocks); with ``impl="jnp"`` it runs the eager path, equal
    to the flat eager call on the same retry draws."""
    if model == "raytraced":
        st = states["headline"][1]
        _, cfg = _raytraced_cfgs("headline", max_tries=3)
        name = "raytraced_rays"
    else:
        _, cfg = _thinlens_cfgs(tmp_path, use_dof=True, max_tries=3,
                                optical_vignetting_distance=4.0,
                                optical_vignetting_radius=0.6)
        st = zpt.compile_camera(cfg, "cpu")
        name = "thinlens_rays"
    fused, calls = getattr(tk, name), []

    def counted(*a, **k):
        sx = a[1] if model == "raytraced" else a[0]  # after the lens
        calls.append(tuple(sx.shape))
        return fused(*a, **k)

    monkeypatch.setattr(tk, name, counted)
    s = [torch.from_numpy(a) for a in _samples(48 * 40, seed=10)]
    for impl, n_calls in (("auto", 1), ("jnp", 0)):
        c = dataclasses.replace(cfg, impl=impl)
        flat, fstats = zpt.create_rays(st, c, *s, seed=11)
        del calls[:]
        grid, gstats = zpt.create_rays(st, c, *(a.reshape(48, 40) for a in s),
                                       seed=11)
        assert calls == [(48 * 40,)] * n_calls
        assert grid.origin.shape == (48, 40, 3) and grid.weight.shape == (48, 40)
        for f in ("origin", "dir", "weight", "d_ody", "d_ddy"):
            np.testing.assert_array_equal(
                getattr(grid, f).reshape(getattr(flat, f).shape).numpy(),
                getattr(flat, f).numpy())
        for f in ("success", "vignetted", "tir", "tries_total"):
            assert int(getattr(gstats, f)) == int(getattr(fstats, f))


@pytest.mark.parametrize("model", ["raytraced", "thinlens"])
def test_impl_jnp_never_reaches_a_kernel(states, model, monkeypatch,
                                         tmp_path):
    def refuse(*a, **k):
        raise AssertionError("impl='jnp' reached a kernel wrapper")

    monkeypatch.setattr(tk, "raytraced_fused", refuse)
    monkeypatch.setattr(tk, "raytraced_rays", refuse)
    monkeypatch.setattr(tk, "thinlens_rays", refuse)
    if model == "raytraced":
        st = states["headline"][1]
        _, cfg = _raytraced_cfgs("headline", max_tries=2)
    else:
        _, cfg = _thinlens_cfgs(tmp_path, use_dof=True, max_tries=2,
                                optical_vignetting_distance=4.0,
                                optical_vignetting_radius=0.6)
        st = zpt.compile_camera(cfg, "cpu")
    s = [torch.from_numpy(a) for a in _samples(512)]
    rays, stats = zpt.create_rays(st, cfg, *s, seed=1)
    assert torch.isfinite(rays.dir).all()
    assert int(stats.success) + int(stats.vignetted) == 512
    with pytest.raises(AssertionError, match="reached a kernel"):
        zpt.create_rays(st, dataclasses.replace(cfg, impl="auto"), *s, seed=1)


# ------------------------------------------------------------ pupil

def _film(n, seed):
    rng = np.random.default_rng(seed)
    r = rng.uniform(0.0, 2.5, n).astype(np.float32)
    th = rng.uniform(-np.pi, np.pi, n)
    lx, ly = (rng.uniform(-1, 1, (2, n)) * 1.2).astype(np.float32)
    return ((r * np.cos(th)).astype(np.float32),
            (r * np.sin(th)).astype(np.float32), r, lx, ly)


def test_shape_sample_matches_jax(states, op_by_op):
    jl, tl = (s.lens for s in states["headline"])
    fx, fy, _, lx, ly = _film(4096, 12)
    jx, jy = jp.shape_sample(jl.lut, *(jnp.asarray(a) for a in (lx, ly, fx, fy)))
    tx, ty = tp.shape_sample(tl.lut, *(torch.from_numpy(a)
                                       for a in (lx, ly, fx, fy)))
    # atan2 rounds its own way in the last bit; fastSin carries it on
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=ATOL)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=ATOL)


@pytest.mark.parametrize("camera", list(MASK_FLIPS))
@pytest.mark.parametrize("use_poly", [False, True])
def test_precheck_matches_jax(states, camera, use_poly, op_by_op):
    """The headline's bound is the circle pair, the fisheye's the
    harmonic series; each lerped per key and from its polynomial (with
    the pre-check off beyond the fitted domain)."""
    jl, tl = (s.lens for s in states[camera])
    assert tl.profile.kind == ("circles" if camera == "headline"
                               else "harmonic")
    _, _, r, lx, ly = _film(8192, 13)
    r = r * 1.3  # past the fitted domain too
    tvals = tp.profile_poly_eval(tl.profile, torch.from_numpy(r))
    jvals = jp.profile_poly_eval(jl.profile, jnp.asarray(r))
    for g, w in zip(tvals, jvals):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    got = tp.precheck_pass(tl.profile, *(torch.from_numpy(a)
                                         for a in (r, lx, ly)),
                           use_poly=use_poly).numpy()
    want = np.asarray(jp.precheck_pass(jl.profile, *(jnp.asarray(a)
                                                     for a in (r, lx, ly)),
                                       use_poly=use_poly))
    assert 0 < got.sum() < got.size
    # the harmonic form's atan2 and cos round their own way in the last bit
    assert (got != want).sum() <= (0 if camera == "headline" else 2)


def test_build_profile_sound_square_domain(states):
    """Square-domain soundness of the port's harmonic bound (after
    ``tests/test_pupil.py:197``): the bound never rejects a square offset
    that the trace accepts, beyond the cover-tail budget."""
    lens = states["headline"][1].lens
    g = torch.Generator().manual_seed(5)
    prof, acc = tp.build_profile(lens, n_samples=20_000, domain="square",
                                 generator=g)
    assert prof.kind == "harmonic" and acc.shape == (32,)
    n = 20_000
    for i, r in enumerate([0.0, 0.9, 1.8]):
        u = torch.rand((2, n), generator=torch.Generator().manual_seed(300 + i))
        lx, ly = u[0] * 2.0 - 1.0, u[1] * 2.0 - 1.0
        fx, fy = torch.full((n,), r), torch.zeros(n)
        px, py = tp.shape_sample(lens.lut, lx, ly, fx, fy)
        oz = torch.zeros(n) + lens.origin_shift
        ok = zpt.trace.trace_stack(
            lens, zpt.optics.V3(fx, fy, oz),
            zpt.optics.V3(px - fx, py - fy, torch.zeros(n) - lens.thickness[0]),
        ).ok
        passed = tp.precheck_pass(prof, fx, lx, ly)
        unsound = int((ok & ~passed).sum())
        assert unsound <= max(2, int(0.0005 * int(ok.sum()))), (r, unsound)
