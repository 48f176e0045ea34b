"""The port's thin-lens path against the JAX package's.

On the CPU the port runs its plain PyTorch version
(``zoic_tpu_torch.ops.trace_kernel.thinlens_plain``); the JAX side runs
``thinlens_fused`` in interpret mode.  Inputs are made with numpy from a
seed and handed to both.  Gates, for every branch (pinhole, DOF, DOF +
vignetting with hash retries, DOF + image bokeh, DOF + image bokeh +
vignetting with retry planes):

* ``tries`` equal on every ray;
* origins and directions within 1e-5 absolute (ROADMAP's oracle gate: the
  interpret-mode program's XLA CPU build contracts fmas, so the last bits
  differ from eager PyTorch).

The presampled + vignetting case hands both the same explicit retry
planes, at a batch whose grid tiles share plane blocks, so the tile-reuse
rotation of the retry-plane draw map is exercised.  At the ``create_rays``
level the port equals ``zoic_tpu.create_rays(impl="pallas")`` when the seed
is shared; with image bokeh and vignetting the JAX path draws its retry
planes with ``jax.random``, so there the vignetting rates are compared.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zoic_tpu as zt
from zoic_tpu.ops import trace_kernel as jtk

import zoic_tpu_torch as zpt
from zoic_tpu_torch.ops import trace_kernel as tk

N = 16 * 128 + 77
SEED = 12345
ATOL = 1e-5
TAN_FOV, AP, FOCAL = 0.36, 1.7857143, 100.0
OVD, OVR = 6.0, 0.35  # strong vignetting: retries and exhausted budgets


def _screen(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, n).astype(np.float32) for _ in range(2)]


def _draws(n, seed, presampled):
    rng = np.random.default_rng(seed)
    lo = -1.0 if presampled else 0.0
    return [rng.uniform(lo, 1, n).astype(np.float32) for _ in range(2)]


def _run_both(sx, sy, u1, u2, *, max_tries, planes=None, **flags):
    scal = (TAN_FOV, AP, FOCAL, OVD, OVR)
    jplanes = {}
    tplanes = {}
    if planes is not None:
        jplanes = dict(retry_u1=jnp.asarray(planes[0]),
                       retry_u2=jnp.asarray(planes[1]))
        tplanes = dict(retry_u1=torch.from_numpy(planes[0]),
                       retry_u2=torch.from_numpy(planes[1]))
    jo, jd, jt = (np.asarray(a) for a in jtk.thinlens_fused(
        *(jnp.asarray(a) for a in (sx, sy, u1, u2)),
        *(jnp.float32(v) for v in scal), jnp.int32(SEED),
        max_tries=max_tries, interpret=True, **flags, **jplanes,
    ))
    before = tk.thinlens_launches
    to, td, tt = (a.numpy() for a in tk.thinlens_fused(
        *(torch.from_numpy(a) for a in (sx, sy, u1, u2)),
        *(torch.tensor(v, dtype=torch.float32) for v in scal), SEED,
        max_tries=max_tries, **flags, **tplanes,
    ))
    assert tk.thinlens_launches == before  # CPU tensors: the plain version
    assert tt.dtype == np.int32 and to.shape == td.shape == (len(sx), 3)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(to, jo, rtol=0, atol=ATOL)
    np.testing.assert_allclose(td, jd, rtol=0, atol=ATOL)
    return tt


@pytest.mark.parametrize(
    "branch,flags",
    [
        ("pinhole", dict(use_dof=False, has_ov=False)),
        ("dof", dict(use_dof=True, has_ov=False)),
        ("dof-vignette", dict(use_dof=True, has_ov=True)),
        ("dof-bokeh", dict(use_dof=True, has_ov=False, presampled=True)),
    ],
)
def test_plain_matches_interpret_kernel(branch, flags):
    sx, sy = _screen(N, 3)
    u1, u2 = _draws(N, 4, flags.get("presampled", False))
    tries = _run_both(sx, sy, u1, u2, max_tries=6, **flags)
    if branch == "dof-vignette":
        assert (tries > 0).any() and (tries == 7).any()
    else:
        assert not tries.any()


@pytest.mark.parametrize("bp", [8192, 10_000])
def test_presampled_vignette_retry_planes(bp):
    """B = 32,768 in 64-row tiles is 4 grid tiles; planes of 8,192 draws are
    one tile (each tile rereads it under the reuse rotation), 10,000 wrap
    to two tiles.  25 retries over 4 planes run 7 reuse cycles."""
    b = 32_768
    sx, sy = _screen(b, 5)
    u1, u2 = _draws(b, 6, True)
    rng = np.random.default_rng(7)
    planes = [rng.uniform(-1, 1, (4, bp)).astype(np.float32)
              for _ in range(2)]
    tile_rows, plane_tiles, reuse = tk.retry_plane_layout(b, bp)
    assert (tile_rows, reuse) == (64, True)
    assert plane_tiles == (1 if bp == 8192 else 2)
    tries = _run_both(sx, sy, u1, u2, max_tries=25, planes=planes,
                      use_dof=True, has_ov=True, presampled=True)
    assert (tries > 8).any() and (tries == 26).any()


def test_presampled_vignette_small_batch_wraps_planes():
    """A batch inside one 32-row tile with 300-draw planes (wrapped to the
    tile) and, with no planes given, the kernel's zero planes."""
    sx, sy = _screen(N, 8)
    u1, u2 = _draws(N, 9, True)
    rng = np.random.default_rng(10)
    planes = [rng.uniform(-1, 1, (2, 300)).astype(np.float32)
              for _ in range(2)]
    assert tk.retry_plane_layout(N, 300) == (32, 1, False)
    flags = dict(use_dof=True, has_ov=True, presampled=True)
    tries = _run_both(sx, sy, u1, u2, max_tries=6, planes=planes, **flags)
    assert (tries > 2).any()
    _run_both(sx, sy, u1, u2, max_tries=0, **flags)


def test_retry_plane_index_is_a_permutation_per_round():
    """Within one round the rays of a plane block read distinct cells."""
    b, bp = 4 * 64 * 128, 64 * 128
    ids = torch.arange(b)
    layout = tk.retry_plane_layout(b, bp)
    for rnd in (1, 5, 26):
        _, pos = tk.retry_plane_index(ids, rnd, 4, bp, *layout)
        for t in range(4):
            cells = pos[t * bp:(t + 1) * bp]
            assert torch.unique(cells).numel() == bp


# ------------------------------------------------------------ create_rays


def _cfgs(**kw):
    base = dict(focal_length=5.0, fstop=1.4, focal_distance=100.0)
    base.update(kw)
    return (zt.CameraConfig(lens_model=zt.LensModel.THINLENS, impl="pallas",
                            **base),
            zpt.CameraConfig(lens_model=zpt.LensModel.THINLENS, **base))


@pytest.fixture(scope="module")
def bokeh_path(tmp_path_factory):
    yy, xx = np.mgrid[-1:1:64j, -1:1:64j]
    img = ((xx**2 + yy**2) < 0.8).astype(np.float32)
    path = str(tmp_path_factory.mktemp("bokeh") / "disk.npy")
    np.save(path, np.stack([img, img, img], -1))
    return path


def _samples(n, seed=21):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, n).astype(np.float32),
            rng.uniform(-1, 1, n).astype(np.float32),
            rng.uniform(0, 1, n).astype(np.float32),
            rng.uniform(0, 1, n).astype(np.float32)]


def _create_both(jcfg, tcfg, n=N, key=42):
    s = _samples(n)
    key = jax.random.PRNGKey(key)
    jr, js = zt.create_rays(zt.compile_camera(jcfg), jcfg,
                            *(jnp.asarray(a) for a in s), key)
    seed = int(jax.random.randint(key, (), 0, 1 << 22))
    tr, ts = zpt.create_rays(zpt.compile_camera(tcfg, "cpu"), tcfg,
                             *(torch.from_numpy(a) for a in s), seed=seed)
    return (jr, js), (tr, ts)


@pytest.mark.parametrize(
    "name,kw",
    [
        ("thinlens_f1.4", dict(use_dof=True)),
        ("thinlens_vignette", dict(use_dof=True,
                                   optical_vignetting_distance=1.0,
                                   optical_vignetting_radius=1.0)),
        ("strong_vignette", dict(use_dof=True, max_tries=4,
                                 optical_vignetting_distance=OVD,
                                 optical_vignetting_radius=OVR)),
        ("pinhole_exposure", dict(use_dof=False, exposure_control=0.5)),
        ("thinlens_bokeh_image", dict(use_dof=True, use_image=True)),
    ],
)
def test_create_rays_matches_jax(name, kw, bokeh_path):
    if kw.get("use_image"):
        kw = dict(kw, bokeh_path=bokeh_path)
    (jr, js), (tr, ts) = _create_both(*_cfgs(**kw))
    for f in ("success", "vignetted", "tir", "tries_total"):
        got, ref = getattr(ts, f), getattr(js, f)
        assert got.dtype == torch.int32, f
        assert int(got) == int(ref), f
    np.testing.assert_array_equal(tr.weight.numpy(), np.asarray(jr.weight))
    for f in ("origin", "dir", "d_ody", "d_ddy"):
        got, ref = getattr(tr, f).numpy(), np.asarray(getattr(jr, f))
        assert got.shape == ref.shape == (N, 3), f
        np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL, err_msg=f)
    if name == "strong_vignette":
        assert int(ts.vignetted) > 0 and int(ts.tries_total) > 0
    if name == "pinhole_exposure":
        np.testing.assert_array_equal(tr.weight.numpy(), np.float32(1.25))


def test_bokeh_vignette_rates_agree(bokeh_path):
    """Image bokeh + vignetting: the retry planes come from jax.random on
    one side and a torch.Generator on the other, so the vignetting rates
    and the mean direction are compared; rays accepted at attempt 0 saw
    the same presampled offset and agree ray for ray."""
    n = 4096
    jcfg, tcfg = _cfgs(use_dof=True, use_image=True, bokeh_path=bokeh_path,
                       optical_vignetting_distance=2.0,
                       optical_vignetting_radius=0.8, max_tries=25)
    s = _samples(n, seed=23)
    jr, js = zt.create_rays(zt.compile_camera(jcfg), jcfg,
                            *(jnp.asarray(a) for a in s),
                            jax.random.PRNGKey(11))
    g = torch.Generator().manual_seed(11)
    tr, ts = zpt.create_rays(zpt.compile_camera(tcfg, "cpu"), tcfg,
                             *(torch.from_numpy(a) for a in s), generator=g)
    assert int(ts.success) + int(ts.vignetted) == n
    assert abs(int(js.vignetted) - int(ts.vignetted)) < max(
        25, 0.1 * (int(js.vignetted) + 10))
    assert abs(int(js.tries_total) - int(ts.tries_total)) < 0.1 * int(
        js.tries_total) + 50
    first = (np.asarray(jr.d_ody) == 0).all(1) & (tr.d_ody.numpy() == 0).all(1)
    np.testing.assert_allclose(tr.dir.numpy()[first],
                               np.asarray(jr.dir)[first], rtol=0, atol=ATOL)
    assert first.sum() > 0.3 * n
    w_j, w_t = np.asarray(jr.weight) > 0, tr.weight.numpy() > 0
    np.testing.assert_allclose(tr.dir.numpy()[w_t].mean(0),
                               np.asarray(jr.dir)[w_j].mean(0), atol=5e-3)


def test_compile_camera_matches_jax(bokeh_path):
    jcfg, tcfg = _cfgs(use_image=True, bokeh_path=bokeh_path,
                       exposure_control=-1.5, sensor_width=2.4)
    js, st = zt.compile_camera(jcfg), zpt.compile_camera(tcfg, "cpu")
    for f in ("fov", "tan_fov", "aperture_radius", "sensor_width",
              "sensor_height", "focal_distance", "ov_distance", "ov_radius",
              "exposure_control"):
        got = getattr(st, f)
        assert got.dtype == torch.float32 and got.shape == (), f
        assert got.numpy().tobytes() == np.asarray(getattr(js, f)).tobytes(), f
    assert st.lens is None and st.bokeh.width == js.bokeh.width == 64
    for f in ("cdf_row", "row_indices", "cdf_col", "col_indices", "dx_col",
              "dy_srow"):
        np.testing.assert_array_equal(getattr(st.bokeh, f).numpy(),
                                      np.asarray(getattr(js.bokeh, f)))


def test_generator_and_seed_paths_are_deterministic(bokeh_path):
    _, tcfg = _cfgs(use_image=True, bokeh_path=bokeh_path,
                    optical_vignetting_distance=2.0,
                    optical_vignetting_radius=0.8)
    st = zpt.compile_camera(tcfg, "cpu")
    s = [torch.from_numpy(a) for a in _samples(500, seed=5)]
    out = [zpt.create_rays(st, tcfg, *s,
                           generator=torch.Generator().manual_seed(9))
           for _ in range(2)]
    out += [zpt.create_rays(st, tcfg, *s, seed=77) for _ in range(2)]
    for a, b in (out[:2], out[2:]):
        np.testing.assert_array_equal(a[0].dir.numpy(), b[0].dir.numpy())
        assert int(a[1].tries_total) == int(b[1].tries_total) > 0
    with pytest.raises(ValueError, match="seed or a torch.Generator"):
        zpt.create_rays(st, tcfg, *s)
    with pytest.raises(ValueError, match="bokeh image"):
        zpt.create_rays(dataclasses.replace(st, bokeh=None), tcfg, *s, seed=1)


def test_compile_camera_refuses_raytraced():
    """RAYTRACED compiles from its lens file now
    (``tests/test_torch_compile_camera.py``); what ``compile_camera``
    refuses is a ``lens_data_path`` that names no readable file, where the
    reference aborts the render (zoic.cpp:1639-1641)."""
    from zoic_tpu_torch.lensfile import LensFileError

    cfg = zpt.CameraConfig(lens_model=zpt.LensModel.RAYTRACED,
                           lens_data_path="double_gauss_f2.0")
    with pytest.raises(LensFileError, match="cannot read lens data file"):
        zpt.compile_camera(cfg, "cpu")


def test_camera_wrapper_is_not_ported():
    """The ``Camera`` wrapper is ported (``tests/test_torch_camera.py``);
    the part of it that is not, the draw session, refuses ``debug.draw``
    naming the ROADMAP item that ports it."""
    cfg = zpt.CameraConfig(lens_model=zpt.LensModel.THINLENS)
    assert zpt.Camera(cfg, "cpu").state.lens is None
    with pytest.raises(NotImplementedError, match="Queue 1 item 7c"):
        zpt.Camera(cfg.replace(debug=zpt.DebugOptions(draw=True)), "cpu")
