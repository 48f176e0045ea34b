"""``zoic_tpu_torch.compile_camera`` for RAYTRACED against the JAX package.

The port compiles from its own lens files; the Monte-Carlo draws of the
iris probe, the exit-pupil LUT and the pre-check's three covers are handed
in as ``uniforms``, JAX's own as ``zoic_tpu.compile_camera`` draws them:
``PRNGKey(7)``, ``PRNGKey(0)``, and for the covers ``fold_in(PRNGKey(0),
1)`` when the LUT is built (the compile's LUT key is then set) or
``PRNGKey(1)`` when it is not, each with its fold-ins 1 and 2.  Op by op
(``jax.disable_jit``, XLA's ``rsqrt``/``cos``/``sin`` taken as the port
defines them) the two compiles are then bit-equal.  Against the jitted
``zoic_tpu.compile_camera`` (XLA's ``rsqrt`` and fma contraction move last
bits, ``tests/test_torch_lensfile_solve.py``):

* the static fields equal, those decided by Monte-Carlo estimates (the
  pre-check's form and polynomial gate, ``dead_frac``) among them;
* the solved arrays within 2e-5 relative, the LUT within 0.03 absolute (a
  flipped borderline sample moves a bounding box by the gap to the next
  survivor, up to about 0.03 as ``tests/test_oracle_parity.py:219-232``
  measured; 0.0013 here on the Petzval at focus 30) and the pre-check's
  per-key coefficients within 0.05 (a flipped sample can move a circle
  center by one 0.025 step of its grid);
* what the state does: ``create_rays`` (the port's, on both states, the JAX
  one through the state bridge) gives equal ``tries`` and ``tir`` on at
  least 99.9% of 2,125 rays.

Two lenses have gates of their own, measured (``GATES``): the fisheye and
the Tessar f/2.8.  The LUT is built at 5,000 samples per key; one case
compiles the headline at the default samples against its shipped state,
with no JAX compile.  Six of the ten cameras, the four lenses no shipped
camera uses and the op-by-op Tessar run with ``--slow``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zoic_tpu as zt
from zoic_tpu.io import state as jax_state_io

import zoic_tpu_torch as zpt
from zoic_tpu_torch import system
from test_torch_trace_pupil import op_by_op  # noqa: F401

N_LUT = 5000
N_RAYS = 2125
SEED = 12345
FAST = ["headline", "raytraced_fisheye", "raytraced_telephoto_f5.0_focus100",
        "raytraced_naive"]
SLOW = [n for n in zpt.data.CAMERAS if n not in FAST]
# the lenses no shipped camera uses
UNSHIPPED = sorted(set(zpt.data.LENSES)
                   - {c.lens for c in zpt.data.CAMERAS.values()})
STATICS = ("aperture_element", "iris_identity", "elem_flags",
           "profile_domain", "profile_poly", "dead_frac")
SOLVED = ("curvature", "thickness", "ior", "abbe", "aperture", "center",
          "user_aperture_radius", "origin_shift", "aperture_distance",
          "focal_length_ratio", "traced_focal_length", "film_diagonal",
          "focal_distance")
LUT_FIELDS = ("keys", "max_scale", "centroid_x", "bbox_min_x", "bbox_min_y",
              "bbox_max_x", "bbox_max_y")
PROFILE_FIELDS = ("keys", "c0", "c1", "c2", "c4")
# gates of their own, measured against the jitted JAX compile (below the
# 0.999 share and the 0.05 coefficient gate of every other camera).  The
# fisheye: its stop is flattened to R = 1e4 cm in a 1 cm lens, so its iris
# hit cancels two ~1e4 terms and the last bits of the solved arrays decide
# draws near the iris edge (3 of 2,125 rays, as in
# ``tests/test_torch_raytraced_variants.py``).  The Tessar f/2.8: 138 of
# 5,000 LUT draws survive at key 3 (film radius 0.375 cm), and one of them,
# y = 0.17186 cm, is the bound's top; XLA's last bits (solved arrays within
# 1.4e-6 relative) reject it, so that key's bbox top is 0.16028 cm, its
# scale 3.5% smaller, and the pre-check circles fitted in the LUT's unit
# domain there move (q1 by 0.158, q2 by 0.067; every other key within
# 0.05); 4 of 2,125 rays, all at film radii between keys 2 and 4, differ
# (39 of 20,000, 1 with the port's LUT put into the JAX state).  Op by op
# the compiles are equal bit for bit (test_tessar_compile_bit_equal_op_by_op).
GATES = {"raytraced_fisheye": {"min_share": 0.995},
         "tessar_f2.8": {"min_share": 0.997, "prof_atol": 0.2}}


def jax_uniforms(n_lut, lut=True):
    """The five draws of ``zoic_tpu.compile_camera`` with its default keys,
    for a camera with the exit-pupil LUT (``lut``) or without it."""
    def draw(key, shape):
        return np.asarray(jax.random.uniform(key, shape, dtype=jnp.float32))

    cover = (jax.random.fold_in(jax.random.PRNGKey(0), 1) if lut
             else jax.random.PRNGKey(1))
    return {
        "iris_probe": draw(jax.random.PRNGKey(7), (2, 32, 2048)),
        "lut": draw(jax.random.PRNGKey(0), (2, 32, n_lut)),
        "cover_fit": draw(cover, (2, 32, 50_000)),
        "cover_held": draw(jax.random.fold_in(cover, 1), (2, 32, 50_000)),
        "cover_mid": draw(jax.random.fold_in(cover, 2), (2, 31, 25_000)),
    }


@pytest.fixture(scope="module")
def bokeh_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bokeh") / "bokeh_disk64.npy")
    np.save(path, zpt.data.bokeh_disk(64))
    return path


def _configs(camera, bokeh_path, **kw):
    """Both packages' configs of a shipped camera, or of a lens of
    :data:`UNSHIPPED` at the render demo's settings (focal length 5 cm, the
    lens's f-stop, focus 100 cm)."""
    if camera in zpt.data.CAMERAS:
        cam = zpt.data.CAMERAS[camera]
        lens, common = cam.lens, dict(
            bokeh_path=bokeh_path if cam.use_image else "",
            **cam.config_kwargs())
    else:
        lens, common = camera, dict(focal_length=5.0,
                                    fstop=zpt.data.LENSES[camera].fstop,
                                    focal_distance=100.0)
    common.update(kw)
    jcfg = zt.CameraConfig(lens_model=zt.LensModel.RAYTRACED,
                           lens_data_path=zt.data.lens_path(lens), **common)
    tcfg = zpt.CameraConfig(lens_model=zpt.LensModel.RAYTRACED,
                            lens_data_path=zpt.data.lens_path(lens), **common)
    return jcfg, tcfg


def bridge(jstate):
    """A JAX-compiled state as the port's, on the CPU."""
    static = jax_state_io._flatten(jstate)[1]
    leaves = [np.asarray(v) for v in jax.tree_util.tree_leaves(jstate)]
    return system.camera_state_from_numpy(
        dict(zip(system.leaf_names(static), leaves)), static, "cpu")


def _statics(lens):
    return {**{f: getattr(lens, f) for f in STATICS},
            "kind": lens.profile.kind, "count": lens.count}


def _assert_same_rays(got, ref, cfg, min_share=0.999):
    rng = np.random.default_rng(7)
    s = [torch.from_numpy(rng.uniform(lo, 1, N_RAYS).astype(np.float32))
         for lo in (-1, -1, 0, 0)]
    from zoic_tpu_torch.models import raytraced as rt
    from zoic_tpu_torch.ops import trace_kernel as tk

    out = []
    for st in (got, ref):
        u1, u2, kw = rt.kernel_inputs(st, cfg, s[2], s[3], SEED)
        out.append(tk.raytraced_plain(st.lens, s[0], s[1], u1, u2,
                                      st.sensor_width, SEED, **kw))
    same = (out[0][2] == out[1][2]) & (out[0][3] == out[1][3])
    assert int(same.sum()) >= min_share * N_RAYS, int((~same).sum())
    return out


def _compare(got, ref, lut_atol=0.03, prof_atol=0.05):
    assert _statics(got.lens) == _statics(ref.lens)
    for f in SOLVED:
        np.testing.assert_allclose(getattr(got.lens, f).numpy(),
                                   getattr(ref.lens, f).numpy(), rtol=2e-5,
                                   atol=0, err_msg=f)
    if ref.lens.lut is not None:
        for f in LUT_FIELDS:
            np.testing.assert_allclose(getattr(got.lens.lut, f).numpy(),
                                       getattr(ref.lens.lut, f).numpy(),
                                       rtol=0, atol=lut_atol, err_msg=f)
    for f in PROFILE_FIELDS:
        np.testing.assert_allclose(getattr(got.lens.profile, f).numpy(),
                                   getattr(ref.lens.profile, f).numpy(),
                                   rtol=0, atol=prof_atol, err_msg=f)


def _check_camera(camera, bokeh_path):
    jcfg, tcfg = _configs(camera, bokeh_path, lut_bounds_samples=N_LUT)
    gate = GATES.get(camera, {})
    ref = bridge(zt.compile_camera(jcfg))
    got = zpt.compile_camera(
        tcfg, "cpu", uniforms=jax_uniforms(N_LUT, tcfg.kolb_sampling_lut))
    assert got.device.type == "cpu"
    assert (got.lens.lut is not None) == tcfg.kolb_sampling_lut
    _compare(got, ref, prof_atol=gate.get("prof_atol", 0.05))
    _assert_same_rays(got, ref, tcfg, gate.get("min_share", 0.999))


@pytest.mark.parametrize("camera", FAST)
def test_compile_matches_jax(camera, bokeh_path):
    _check_camera(camera, bokeh_path)


@pytest.mark.slow
@pytest.mark.parametrize("camera", SLOW)
def test_compile_matches_jax_slow(camera, bokeh_path):
    _check_camera(camera, bokeh_path)


@pytest.mark.slow
@pytest.mark.parametrize("lens", UNSHIPPED)
def test_unshipped_lens_compile_matches_jax(lens):
    """The lenses no shipped camera uses, at the render demo's settings."""
    _check_camera(lens, "")


@pytest.mark.slow
def test_tessar_compile_bit_equal_op_by_op(op_by_op):
    """Op by op the Tessar's whole compile, pre-check covers included, is
    the JAX package's bit for bit: its gap against the jitted compile
    (``GATES``) is XLA's rounding, not a fault."""
    jcfg, tcfg = _configs("tessar_f2.8", "", lut_bounds_samples=N_LUT)
    # the default LUT key, passed: tests/conftest.py memoises compiles
    # without one, and a jitted compile of this config may be in the memo
    ref = bridge(zt.compile_camera(jcfg, jax.random.PRNGKey(0)))
    got = zpt.compile_camera(tcfg, "cpu", uniforms=jax_uniforms(N_LUT))
    assert _statics(got.lens) == _statics(ref.lens)
    for part, fields in ((None, SOLVED), ("lut", LUT_FIELDS),
                         ("profile", PROFILE_FIELDS + ("poly", "poly_scale"))):
        a = getattr(got.lens, part) if part else got.lens
        b = getattr(ref.lens, part) if part else ref.lens
        for f in fields:
            np.testing.assert_array_equal(getattr(a, f).numpy(),
                                          getattr(b, f).numpy(), err_msg=f)
    _assert_same_rays(got, ref, tcfg, 1.0)


@pytest.mark.parametrize("lut", [True, False], ids=["lut", "naive"])
def test_jax_uniforms_are_the_compiles_draws(lut, monkeypatch):
    """``jax_uniforms`` hands the port the draws ``zoic_tpu.compile_camera``
    makes itself: the LUT's and the three pre-check covers', recorded from
    the keys the JAX compile passes down (it stops after the last cover)."""
    from zoic_tpu import pupil as jp

    class Drawn(Exception):
        pass

    def draw(key, shape):
        return np.asarray(jax.random.uniform(key, shape, dtype=jnp.float32))

    seen = {}
    build_lut = jp.build_lut

    def record_lut(lens, key, n_film, n_samples):
        seen["lut"] = draw(key, (2, n_film, n_samples))
        return build_lut(lens, key, n_film, n_samples)

    covers = iter(("cover_fit", "cover_held", "cover_mid"))

    def record_cover(lens, key, radii, n_samples, domain):
        seen[next(covers)] = draw(key, (2, radii.shape[0], n_samples))
        if "cover_mid" in seen:
            raise Drawn
        return None, None, None

    monkeypatch.setattr(jp, "build_lut", record_lut)
    monkeypatch.setattr(jp, "_cover_trace", record_cover)
    jcfg, _ = _configs("headline", "", lut_bounds_samples=64,
                       kolb_sampling_lut=lut)
    with pytest.raises(Drawn):
        zt.compile_camera(jcfg)
    want = jax_uniforms(64, lut)
    assert set(seen) == set(want) - {"iris_probe"} - (set() if lut
                                                       else {"lut"})
    for name, u in seen.items():
        np.testing.assert_array_equal(u, want[name], err_msg=name)


def test_default_compile_matches_shipped_headline():
    """The default LUT samples (100,000 per key) with JAX's draws against
    the state shipped with the port, which the JAX package compiled with
    them: no JAX compile here."""
    _, tcfg = _configs("headline", "")
    got = zpt.compile_camera(tcfg, "cpu",
                             uniforms=jax_uniforms(tcfg.lut_bounds_samples))
    ref = zpt.load_state(zpt.data.state_path("headline"), device="cpu")
    _compare(got, ref)
    _assert_same_rays(got, ref, tcfg)


def test_compile_draws_from_a_generator():
    """Without ``uniforms`` the draws come from ``generator`` (a CPU one
    here), seeded 0 when absent: the same seed gives the same state, and a
    wrong uniforms shape is refused."""
    _, tcfg = _configs("raytraced_naive", "", lut_bounds_samples=N_LUT)
    a = zpt.compile_camera(tcfg, "cpu")
    b = zpt.compile_camera(tcfg, "cpu",
                           generator=torch.Generator().manual_seed(0))
    for f in ("c0", "c1", "c2", "c4", "poly"):
        assert torch.equal(getattr(a.lens.profile, f),
                           getattr(b.lens.profile, f)), f
    assert a.lens.lut is None and a.lens.profile is not None
    bad = dict(jax_uniforms(N_LUT), cover_fit=np.zeros((2, 32, 10), np.float32))
    with pytest.raises(ValueError, match="cover_fit"):
        zpt.compile_camera(tcfg, "cpu", uniforms=bad)
    with pytest.raises(ValueError, match="unknown uniforms"):
        zpt.compile_camera(tcfg, "cpu", uniforms={"luts": bad["lut"]})
    no_pre = dataclasses.replace(tcfg, pupil_precheck=False)
    assert zpt.compile_camera(no_pre, "cpu").lens.profile is None
