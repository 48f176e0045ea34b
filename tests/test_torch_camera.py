"""The port's library surface against the JAX package's, on the CPU.

``Camera`` (the ``update`` split, its draws, the run stats), ``render``,
state files and the compile cache, data parallelism over device lists,
``interop`` and the native host library, after
``tests/test_camera_update.py``, ``tests/test_state_io.py``,
``tests/test_interop.py`` and ``tests/test_native.py``.  Compiles skip the
pupil pre-check and use ``lut_bounds_samples=4_000`` to stay cheap; the
pre-check's leaves come from the shipped states, which both packages read.
"""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zoic_tpu as jt
from zoic_tpu import interop as j_interop
from zoic_tpu import render as j_render
from zoic_tpu import solve as j_solve
from zoic_tpu.io import state as jax_state_io

import zoic_tpu_torch as zpt
from zoic_tpu_torch import interop, render
from zoic_tpu_torch.io import state as state_io
from zoic_tpu_torch.parallel import sharding
from zoic_tpu_torch.system import leaf_names
from zoic_tpu_torch.utils import native
from _torch_threads import one_thread  # noqa: F401


def _cfg(**kw):
    kw.setdefault("focal_length", 5.0)
    kw.setdefault("fstop", 2.0)
    kw.setdefault("focal_distance", 100.0)
    kw.setdefault("pupil_precheck", False)
    return zpt.CameraConfig(
        lens_model=zpt.LensModel.RAYTRACED,
        lens_data_path=zpt.data.lens_path("double_gauss_f2.0"),
        lut_bounds_samples=4_000, **kw)


def _bokeh_file(tmp_path, name, r2=0.8):
    yy, xx = np.mgrid[-1:1:32j, -1:1:32j]
    img = ((xx**2 + yy**2) < r2).astype(np.float32)
    p = str(tmp_path / name)
    np.save(p, np.stack([img, img, img], -1))
    return p + ".npy"


def _samples(n, seed):
    g = torch.Generator().manual_seed(seed)
    u = torch.rand((4, n), generator=g)
    return u[0] * 2 - 1, u[1] * 2 - 1, u[2], u[3]


@pytest.fixture(scope="module")
def headline():
    cfg = zpt.CameraConfig(
        lens_model=zpt.LensModel.RAYTRACED,
        lens_data_path=zpt.data.lens_path("double_gauss_f2.0"),
        focal_length=5.0, fstop=2.0, focal_distance=100.0)
    return zpt.load_state(zpt.data.state_path(), device="cpu"), cfg


# ---------------------------------------------------------------- Camera

def test_update_semantics(tmp_path):
    bok_a = _bokeh_file(tmp_path, "a", 0.8)
    bok_b = _bokeh_file(tmp_path, "b", 0.5)
    cfg = _cfg(use_image=True, bokeh_path=bok_a)
    cam = zpt.Camera(cfg, "cpu", generator=torch.Generator().manual_seed(123))
    lens_before, bokeh_before = cam.state.lens, cam.state.bokeh

    # a bokeh-only change rebuilds the image and keeps the lens object
    cam.update(cfg.replace(bokeh_path=bok_b))
    assert cam.state.lens is lens_before
    assert cam.state.bokeh is not bokeh_before
    assert not torch.equal(cam.state.bokeh.cdf_row, bokeh_before.cdf_row)

    # scalars refresh without a recompile
    cam.update(cam.config.replace(exposure_control=2.0,
                                  optical_vignetting_distance=3.0))
    assert cam.state.lens is lens_before
    assert float(cam.state.exposure_control) == 2.0
    assert float(cam.state.ov_distance) == 3.0

    # a solve change recompiles with the camera's original draws
    cfg2 = cam.config.replace(focal_distance=50.0)
    cam.update(cfg2)
    fresh = zpt.compile_camera(cfg2, "cpu",
                               generator=torch.Generator().manual_seed(123))
    other = zpt.compile_camera(cfg2, "cpu",
                               generator=torch.Generator().manual_seed(124))
    assert torch.equal(cam.state.lens.lut.max_scale, fresh.lens.lut.max_scale)
    assert not torch.equal(cam.state.lens.lut.max_scale,
                           other.lens.lut.max_scale)
    assert float(cam.state.lens.origin_shift) != float(lens_before.origin_shift)
    assert float(cam.state.exposure_control) == 2.0


def test_update_default_draws_and_uniforms():
    """Without a generator the camera compiles as ``compile_camera`` does
    (a generator seeded 0); ``uniforms=`` are reused by a recompile."""
    cfg = _cfg()
    cam = zpt.Camera(cfg, "cpu")
    assert torch.equal(cam.state.lens.lut.centroid_x,
                       zpt.compile_camera(cfg, "cpu").lens.lut.centroid_x)
    u = {"lut": np.random.default_rng(0).uniform(
        size=(2, 32, 4_000)).astype(np.float32)}
    cam = zpt.Camera(cfg, "cpu", uniforms=u)
    cam.update(cfg.replace(fstop=2.8))
    want = zpt.compile_camera(cfg.replace(fstop=2.8), "cpu", uniforms=u)
    assert torch.equal(cam.state.lens.lut.max_scale, want.lens.lut.max_scale)


def test_log_stats_and_totals(caplog):
    cam = zpt.Camera(_cfg(kolb_sampling_lut=False, fstop=8.0), "cpu")
    stats = [cam.create_rays(*_samples(1024, s), seed=s)[1] for s in (1, 2)]
    assert cam.stats_totals.dtype == torch.int64
    want = [sum(int(getattr(st, f)) for st in stats)
            for f in ("success", "vignetted", "tir")]
    assert cam.stats_totals.tolist() == want
    assert want[0] + want[1] == 2048 and want[1] > 0
    with caplog.at_level(logging.INFO, logger="zoic"):
        cam.finish()
    lines = [r.getMessage() for r in caplog.records]
    assert lines == [
        f"{'[ZOIC] Succesful rays':<40} {want[0]:12d}",
        f"{'[ZOIC] Vignetted rays':<40} {want[1]:12d}",
        f"{'[ZOIC] Vignetted Percentage':<40} "
        f"{want[1] / 2048 * 100.0:12.8f}",
        f"{'[ZOIC] Total internal reflection cases':<40} {want[2]:12d}",
    ]


# ---------------------------------------------------------------- render

def test_render_frame(headline):
    st, cfg = headline
    spec = render.FrameSpec(64, 48, spp=2)
    g = torch.Generator().manual_seed(3)
    rays, stats = render.render_rays(st, cfg, spec, g)
    assert rays.origin.shape == (spec.n_samples, 3)
    img = render.weight_image(spec, rays)
    assert img.shape == (48, 64)
    assert int(stats.success) + int(stats.vignetted) == spec.n_samples
    assert float(img[24, 32]) >= float(img[0, 0]) - 1e-6
    # render_rays is create_rays on frame_samples, then the seed, from one
    # generator
    g = torch.Generator().manual_seed(3)
    again = zpt.create_rays(st, cfg, *render.frame_samples(spec, g),
                            generator=g)[0]
    for f in ("origin", "dir", "weight"):
        assert torch.equal(getattr(rays, f), getattr(again, f))


@pytest.mark.parametrize("spec", [(64, 48, 2), (37, 11, 3)])
def test_frame_samples_match_jax(spec):
    spec_j, spec_t = j_render.FrameSpec(*spec), render.FrameSpec(*spec)
    jsx, jsy, _, _ = j_render.frame_samples(spec_j, jax.random.PRNGKey(0),
                                            jitter=False)
    tsx, tsy, tu, tv = render.frame_samples(spec_t, jitter=False,
                                            device="cpu")
    np.testing.assert_array_equal(tsx.numpy(), np.asarray(jsx))
    np.testing.assert_array_equal(tsy.numpy(), np.asarray(jsy))
    assert tu.shape == (spec_t.n_samples,) and float(tu.max()) < 1.0


# ------------------------------------------------------------ state files

def _leaves_equal(path_a, path_b):
    with np.load(path_a) as a, np.load(path_b) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("camera", sorted(zpt.data.CAMERAS))
def test_shipped_state_resaved_by_port(tmp_path, camera):
    """A JAX-saved state, loaded and saved by the port, is the same file
    content, and the JAX loader reads it back."""
    src = zpt.data.state_path(camera)
    out = str(tmp_path / "port.npz")
    state_io.save(out, zpt.load_state(src, device="cpu"))
    _leaves_equal(src, out)
    jax_state_io.load(out)


def test_port_compiled_state_loads_in_jax(tmp_path):
    """States the port compiles (raytraced with a LUT, thin lens with
    image bokeh) read back leaf for leaf by both loaders."""
    bok = _bokeh_file(tmp_path, "b")
    thin = zpt.CameraConfig(lens_model=zpt.LensModel.THINLENS,
                            focal_length=5.0, fstop=1.4, focal_distance=100.0,
                            use_image=True, bokeh_path=bok)
    for i, cfg in enumerate((_cfg(), thin)):
        st = zpt.compile_camera(cfg, "cpu")
        path = str(tmp_path / f"s{i}.npz")
        state_io.save(path, st)
        static = state_io._static(st)
        back = state_io.load(path, device="cpu")
        jback = jax_state_io.load(path)
        leaves = jax.tree_util.tree_leaves(jback)
        assert len(leaves) == len(leaf_names(static))
        for name, leaf in zip(leaf_names(static), leaves):
            want = state_io._leaf(st, name)
            np.testing.assert_array_equal(np.asarray(leaf), want, err_msg=name)
            assert np.asarray(leaf).dtype == want.dtype, name
            np.testing.assert_array_equal(state_io._leaf(back, name), want)


def test_state_round_trip_gives_equal_rays(tmp_path, headline):
    st, cfg = headline
    p = str(tmp_path / "cam.npz")
    state_io.save(p, st)
    st2 = state_io.load(p, device="cpu")
    s = _samples(512, 0)
    r1, s1 = zpt.create_rays(st, cfg, *s, seed=5)
    r2, s2 = zpt.create_rays(st2, cfg, *s, seed=5)
    for f in ("origin", "dir", "weight"):
        assert torch.equal(getattr(r1, f), getattr(r2, f))
    assert int(s1.vignetted) == int(s2.vignetted)


def test_cached_compile(tmp_path):
    cfg = _cfg()
    st1 = state_io.cached_compile(cfg, str(tmp_path), "cpu")
    st2 = state_io.cached_compile(cfg, str(tmp_path), "cpu")  # from disk
    assert torch.equal(st1.lens.curvature, st2.lens.curvature)
    assert torch.equal(st1.lens.lut.max_scale, st2.lens.lut.max_scale)
    assert [p.name for p in tmp_path.iterdir()] == [
        state_io.cache_path(str(tmp_path), cfg).split("/")[-1]]
    # another focus is another entry
    state_io.cached_compile(cfg.replace(focal_distance=60.0), str(tmp_path),
                            "cpu")
    assert len(list(tmp_path.iterdir())) == 2


# --------------------------------------------------------------- sharding

def test_sharded_matches_unsharded(headline):
    """A split batch equals the whole on the first attempt (the retries of
    the shards take their own seeds)."""
    st, cfg = headline
    cfg = cfg.replace(max_tries=0, impl="jnp")
    s = _samples(1024, 2)
    rays, _ = zpt.create_rays(st, cfg, *s, seed=0)
    mesh = sharding.make_mesh(["cpu"] * 4)
    srays, sstats = sharding.create_rays_sharded(mesh, st, cfg, *s, seed=0)
    ok = rays.weight > 0
    assert torch.equal(ok, srays.weight > 0)
    assert torch.equal(rays.dir[ok], srays.dir[ok])
    assert sstats.success.dtype == torch.int32
    assert int(sstats.success) + int(sstats.vignetted) == 1024


def test_mesh_of_one_equals_plain_call(headline):
    st, cfg = headline
    s = _samples(1024, 3)
    rays, stats = zpt.create_rays(st, cfg, *s, seed=77)
    srays, sstats = sharding.create_rays_sharded(
        sharding.make_mesh(["cpu"]), st, cfg, *s, seed=77)
    for f in ("origin", "dir", "weight", "d_ody", "d_ddy"):
        assert torch.equal(getattr(rays, f), getattr(srays, f))
    for f in ("success", "vignetted", "tir", "tries_total"):
        assert int(getattr(stats, f)) == int(getattr(sstats, f))


def test_sharded_deterministic_and_decorrelated(headline):
    """Identical samples on every shard: the first attempts agree across
    shards, retried rays differ (per-shard seeds), and two runs give the
    same bits."""
    st, cfg = headline
    cfg = cfg.replace(max_tries=4, pupil_precheck=False)
    mesh = sharding.make_mesh(["cpu"] * 4)
    per = 128
    s = [a.repeat(4) for a in _samples(per, 4)]
    rays, stats = sharding.create_rays_sharded(mesh, st, cfg, *s, seed=1)
    rays2, _ = sharding.create_rays_sharded(
        mesh, st, cfg, *sharding.shard_samples(mesh, *s), seed=1)
    assert int(stats.success) + int(stats.vignetted) == 4 * per
    assert torch.equal(rays.dir, rays2.dir)
    d = rays.dir.reshape(4, per, 3)
    w = rays.weight.reshape(4, per)
    first_ok = (w > 0).all(0) & (d == d[0]).all(2).all(0)
    assert first_ok.sum() > per // 2
    retried = ~first_ok
    assert retried.any()
    assert not torch.equal(d[:, retried], d[0:1, retried].expand(4, -1, 3))


def test_sharded_batch_must_divide(headline):
    st, cfg = headline
    with pytest.raises(ValueError, match="not divisible by mesh size 3"):
        sharding.create_rays_sharded(sharding.make_mesh(["cpu"] * 3), st,
                                     cfg, *_samples(1000, 0), seed=0)


# ------------------------------------------------------ interop and native

def test_maya_conversion_units():
    kw = dict(focal_length_mm=50.0, horizontal_film_aperture_in=1.41732,
              vertical_film_aperture_in=0.94488, focus_distance=150.0,
              f_stop=2.8)
    cfg = interop.from_maya_camera(**kw)
    assert cfg.focal_length == pytest.approx(5.0)
    assert cfg.sensor_width == pytest.approx(3.6, abs=1e-3)
    assert cfg.sensor_height == pytest.approx(2.4, abs=1e-3)
    assert cfg.focal_distance == 150.0 and cfg.fstop == 2.8 and cfg.use_dof
    assert interop.to_node_parameters(cfg) == j_interop.to_node_parameters(
        j_interop.from_maya_camera(**kw))


def test_node_parameter_round_trip():
    cfg = zpt.CameraConfig(
        lens_model=zpt.LensModel.RAYTRACED,
        lens_data_path=zpt.data.lens_path("tessar_f2.8"),
        focal_length=5.0, fstop=2.8, focal_distance=42.0,
        optical_vignetting_distance=1.5, exposure_control=0.5,
    )
    params = interop.to_node_parameters(cfg)
    assert params["sensorWidth"] == 3.6
    assert params["lensModel"] == 1
    assert params["kolbSamplingLUT"] is True
    back = interop.from_node_parameters(params)
    assert back.lens_key() == cfg.lens_key()
    assert back.exposure_control == 0.5
    assert interop.node_parameter_schema(cfg) == j_interop.node_parameter_schema(
        jt.CameraConfig(**{f.name: getattr(cfg, f.name)
                           for f in dataclasses.fields(cfg)
                           if f.name not in ("lens_model", "debug")},
                        lens_model=jt.LensModel.RAYTRACED))


def _need_native():
    if not native.available():
        pytest.skip("native host library unavailable (needs g++)")


@pytest.mark.parametrize("name", sorted(zpt.data.LENSES))
def test_native_parse_matches_python(name):
    _need_native()
    path = zpt.data.lens_path(name)
    c, t, i, a, ap, ap_el = native.parse_lens(path)
    rx = zpt.lensfile.load(path)
    assert ap_el == rx.aperture_element
    np.testing.assert_allclose(c, np.asarray(rx.curvature, np.float64),
                               rtol=1e-6)
    np.testing.assert_allclose(t, np.asarray(rx.thickness, np.float64),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(i, np.asarray(rx.ior, np.float64), rtol=1e-6)
    np.testing.assert_allclose(ap, np.asarray(rx.aperture, np.float64),
                               rtol=1e-6)


def test_native_solvers_match_port():
    """The float64 native solvers agree with the port's float32 solvers
    to float32 precision, as with the JAX package's."""
    _need_native()
    path = zpt.data.lens_path("double_gauss_f2.0")
    c, t, i, a, ap, _ = native.parse_lens(path)
    focal, pp, _ = native.trace_focal(c, t, i, ap)
    rx = zpt.lensfile.load(path)
    p = zpt.solve.from_lensfile(rx, "cpu")
    tr = zpt.solve.trace_focal_length(p)
    assert float(tr.focal_length) == pytest.approx(focal, rel=2e-5)
    assert float(tr.principal_plane) == pytest.approx(pp, rel=2e-4)
    ratio = 5.0 / focal
    for arr in (c, t, ap):
        arr *= ratio
    img = native.image_distance(c, t, i, ap, 100.0)
    p2 = zpt.solve.rescale(p, torch.tensor(5.0) / tr.focal_length)
    img_t = float(zpt.solve.image_distance(p2, torch.tensor(100.0)))
    assert img_t == pytest.approx(img, rel=5e-5, abs=5e-4)
    img_j = float(j_solve.image_distance(
        j_solve.rescale(j_solve.from_lensfile(jt.lensfile.load(
            jt.data.lens_path("double_gauss_f2.0"))),
            jnp.float32(5.0) / jnp.float32(float(tr.focal_length))),
        jnp.float32(100.0)))
    assert img_t == pytest.approx(img_j, rel=1e-5, abs=1e-5)
