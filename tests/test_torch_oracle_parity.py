"""The port against the standalone C++ oracle (``tools/oracle/oracle.cpp``).

The North star's gate, after ``tests/test_oracle_parity.py``: ray
directions within 1e-5 RMSE of the C++ implementation of the reference's
float32 camera math, origins within 1e-4, bokeh samples bit-equal, and
every derived lens quantity of the solve against the oracle's goldens, per
lens file.  The first attempt is deterministic: with ``max_tries=0`` a
ray's weight is positive iff its first attempt succeeded.  The port runs
on the CPU: its kernel path (the plain versions) and its eager path are
both held to the gates.  Two lenses run by default, the Double Gauss and
the fisheye (the most extreme angles); the rest are marked ``slow``.
"""

import dataclasses
import hashlib
import json
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

import zoic_tpu_torch as zpt
from zoic_tpu_torch import lensfile, solve
from _torch_threads import one_thread  # noqa: F401

_REPO = os.path.join(os.path.dirname(__file__), "..")
ORACLE_SRC = os.path.join(_REPO, "tools", "oracle", "oracle.cpp")
# beside the port's other host builds, inside the checkout (gitignored)
BUILD_DIR = os.path.join(_REPO, "build", "zoic_tpu_torch")
_REPRESENTATIVE = {"double_gauss_f2.0", "fisheye_muller_f4.0"}
SOLVE_PARAMS = dict(focal_length=5.0, fstop=2.0, focal_distance=100.0)
IMPLS = ["auto", "jnp"]  # the kernel path (plain on the CPU) and the eager


def _lens_params():
    return [pytest.param(n, marks=() if n in _REPRESENTATIVE
                         else (pytest.mark.slow,))
            for n in sorted(zpt.data.LENSES)]


@pytest.fixture(scope="session")
def oracle():
    if shutil.which("g++") is None:
        pytest.skip("g++ unavailable")
    with open(ORACLE_SRC, "rb") as f:
        src_hash = hashlib.sha256(f.read()).hexdigest()[:16]
    exe = os.path.join(BUILD_DIR, f"oracle-{src_hash}")
    if not os.path.exists(exe):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{exe}.build.{os.getpid()}"
        subprocess.run(["g++", "-O2", "-std=c++17", "-o", tmp, ORACLE_SRC],
                       check=True)
        os.replace(tmp, exe)  # atomic under concurrent sessions

    def run(args, stdin=""):
        out = subprocess.run([exe] + [str(a) for a in args], input=stdin,
                             capture_output=True, text=True, check=True)
        return json.loads(out.stdout)

    return run


def _rays_stdin(sx, sy, u, v):
    return "\n".join(f"{a:.9g} {b:.9g} {c:.9g} {d:.9g}"
                     for a, b, c, d in zip(sx, sy, u, v))


def _want(rays):
    return (np.array([r["ok"] for r in rays]),
            np.array([r["origin"] for r in rays], np.float32),
            np.array([r["dir"] for r in rays], np.float32))


def _rmse(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2)))


def _config(path, **kw):
    return zpt.CameraConfig(lens_model=zpt.LensModel.RAYTRACED,
                            lens_data_path=path, max_tries=0,
                            pupil_precheck=False, **SOLVE_PARAMS, **kw)


@pytest.mark.parametrize("name", _lens_params())
def test_solve_golden(oracle, name):
    """Every derived quantity of the lens compile (zoic.cpp:1615-1698)."""
    path = zpt.data.lens_path(name)
    want = oracle(["solve", path, 5.0, 2.0, 100.0])
    system, report = solve.solve_lens(
        lensfile.load(path), _config(path, kolb_sampling_lut=False), "cpu")
    assert system.count == want["count"]
    assert system.aperture_element == want["aperture_element"]
    rel = 2e-4  # float32 op order of two implementations
    assert float(report["traced_focal_length_raw"]) == pytest.approx(
        want["focal_raw"], rel=rel)
    assert float(report["principal_plane_raw"]) == pytest.approx(
        want["pp_raw"], rel=rel)
    assert float(report["focal_length_ratio"]) == pytest.approx(
        want["ratio"], rel=rel)
    assert float(system.traced_focal_length) == pytest.approx(
        want["focal"], rel=rel)
    assert float(system.user_aperture_radius) == pytest.approx(
        want["user_aperture_radius"], rel=rel)
    assert float(system.origin_shift) == pytest.approx(
        want["origin_shift"], rel=3e-4, abs=2e-4)
    np.testing.assert_allclose(system.curvature.numpy(),
                               np.asarray(want["curvature"]), rtol=1e-5)
    np.testing.assert_allclose(system.thickness.numpy(),
                               np.asarray(want["thickness"]), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(system.aperture.numpy(),
                               np.asarray(want["aperture"]), rtol=1e-5)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", _lens_params())
def test_raytraced_first_attempt_rmse(oracle, name, impl):
    """Naive first-element targeting, 1,024 rays: direction RMSE < 1e-5,
    origin RMSE < 1e-4; ok masks equal on the eager path (the reference's
    op order).  The kernel path's concentric map is restructured (one
    divide, ``trace_kernel.concentric``) and parts from the reference's in
    the last bit, so a ray on a cull boundary may flip there (1 of 1,024
    on the Petzval f/1.25): at most 0.5%, the LUT gate's share."""
    path = zpt.data.lens_path(name)
    n = 1024
    rng = np.random.default_rng(7)
    sx, sy = (rng.uniform(-1, 1, n).astype(np.float32) for _ in range(2))
    u, v = (rng.uniform(0, 1, n).astype(np.float32) for _ in range(2))
    w_ok, w_origin, w_dir = _want(oracle(
        ["trace", path, 5.0, 2.0, 100.0, n],
        stdin=_rays_stdin(sx, sy, u, v))["rays"])
    cfg = _config(path, kolb_sampling_lut=False, impl=impl)
    state = zpt.compile_camera(cfg, "cpu")
    rays, _ = zpt.create_rays(state, cfg, *(torch.from_numpy(a)
                                            for a in (sx, sy, u, v)), seed=0)
    got_ok = rays.weight.numpy() > 0.0
    assert (got_ok != w_ok).sum() <= (0 if impl == "jnp" else 0.005 * n)
    both = got_ok & w_ok
    assert _rmse(rays.dir.numpy()[both], w_dir[both]) < 1e-5
    assert _rmse(rays.origin.numpy()[both], w_origin[both]) < 1e-4


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", _lens_params())
def test_raytraced_lut_first_attempt_rmse(oracle, name, impl):
    """The LUT-shaped path (the North star's config): the exit-pupil LUT
    built from the same uniforms on both sides (``uniforms=``), then the
    rays with the oracle's table in the state, so that any residual is
    the shaping transform and the trace themselves."""
    path = zpt.data.lens_path(name)
    n_film, n_samp, n = 32, 4096, 1024
    rng = np.random.default_rng(13)
    lut_u = rng.uniform(0, 1, (2, n_film, n_samp)).astype(np.float32)
    sx, sy = (rng.uniform(-1, 1, n).astype(np.float32) for _ in range(2))
    u, v = (rng.uniform(0, 1, n).astype(np.float32) for _ in range(2))
    stdin = ("\n".join(f"{x:.9g}" for x in lut_u.reshape(-1)) + "\n"
             + _rays_stdin(sx, sy, u, v))
    want = oracle(["tracelut", path, 5.0, 2.0, 100.0, n_film, n_samp, n],
                  stdin=stdin)
    cfg = _config(path, kolb_sampling_lut=True, impl=impl,
                  lut_film_samples=n_film, lut_bounds_samples=n_samp)
    state = zpt.compile_camera(cfg, "cpu", uniforms={"lut": lut_u})
    lut = state.lens.lut
    # a boundary sample whose cull flips under the two implementations'
    # op order moves a bbox edge (observed for the fisheye)
    np.testing.assert_allclose(lut.max_scale.numpy(),
                               np.asarray(want["max_scale"], np.float32),
                               rtol=5e-3, atol=1e-5)
    np.testing.assert_allclose(lut.centroid_x.numpy(),
                               np.asarray(want["centroid"], np.float32),
                               rtol=5e-3, atol=0.03)
    lut = dataclasses.replace(
        lut, max_scale=torch.tensor(want["max_scale"], dtype=torch.float32),
        centroid_x=torch.tensor(want["centroid"], dtype=torch.float32))
    state = dataclasses.replace(
        state, lens=dataclasses.replace(state.lens, lut=lut))
    w_ok, w_origin, w_dir = _want(want["rays"])
    rays, _ = zpt.create_rays(state, cfg, *(torch.from_numpy(a)
                                            for a in (sx, sy, u, v)), seed=0)
    got_ok = rays.weight.numpy() > 0.0
    # LUT-shaped samples land on the pupil cover's boundary: a few cull
    # decisions flip with the op order, as in the JAX package's gate
    assert (got_ok == w_ok).mean() > 0.995
    both = got_ok & w_ok
    assert _rmse(rays.dir.numpy()[both], w_dir[both]) < 1e-5
    assert _rmse(rays.origin.numpy()[both], w_origin[both]) < 1e-4


@pytest.mark.parametrize("impl", IMPLS)
def test_thinlens_first_attempt_rmse(oracle, impl):
    n = 2048
    rng = np.random.default_rng(11)
    sx, sy = (rng.uniform(-1, 1, n).astype(np.float32) for _ in range(2))
    u, v = (rng.uniform(0, 1, n).astype(np.float32) for _ in range(2))
    want = oracle(["thinlens", 3.6, 2.4, 5.0, 1.4, 100.0, 4.0, 0.6, n],
                  stdin=_rays_stdin(sx, sy, u, v))
    w_ok, w_origin, w_dir = _want(want["rays"])
    cfg = zpt.CameraConfig(
        lens_model=zpt.LensModel.THINLENS, focal_length=5.0, fstop=1.4,
        focal_distance=100.0, use_dof=True, optical_vignetting_distance=4.0,
        optical_vignetting_radius=0.6, max_tries=0, impl=impl)
    state = zpt.compile_camera(cfg, "cpu")
    rays, _ = zpt.create_rays(state, cfg, *(torch.from_numpy(a)
                                            for a in (sx, sy, u, v)), seed=0)
    got_ok = rays.weight.numpy() > 0.0
    np.testing.assert_array_equal(got_ok, w_ok)
    assert _rmse(rays.dir.numpy()[got_ok], w_dir[w_ok]) < 1e-5
    assert _rmse(rays.origin.numpy()[got_ok], w_origin[w_ok]) < 1e-5
    assert float(state.tan_fov) == pytest.approx(want["tan_fov"], rel=1e-6)
    assert float(state.aperture_radius) == pytest.approx(
        want["aperture_radius"], rel=1e-6)


def test_bokeh_sample_bit_parity(oracle):
    """The two-level CDF inversion maps the same uniforms to the same
    offsets, bit for bit (both sides use stable descending sorts)."""
    rng = np.random.default_rng(3)
    h = w = 16
    img = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    n = 512
    ur, uc = (rng.uniform(0, 1, n).astype(np.float32) for _ in range(2))
    stdin = ("\n".join(" ".join(f"{x:.9g}" for x in px)
                       for px in img.reshape(-1, 3)) + "\n"
             + "\n".join(f"{a:.9g} {b:.9g}" for a, b in zip(ur, uc)))
    want = np.array(oracle(["bokeh", w, h, n], stdin=stdin)["samples"],
                    np.float32)
    dx, dy = zpt.bokeh.sample(zpt.bokeh.build(img), torch.from_numpy(ur),
                              torch.from_numpy(uc))
    np.testing.assert_array_equal(np.stack([dx.numpy(), dy.numpy()], -1),
                                  want)
