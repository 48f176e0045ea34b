"""The port's element-stack tracer, iris probe, exit-pupil LUT and pupil
pre-check against the JAX package's, on the same compiled lenses.

Both packages get the same lens (a shipped state, read by each package's
own loader) and the same uniforms.  Gates:

* op by op (``jax.disable_jit``, with XLA's ``rsqrt`` taken as ``1 / sqrt``
  and its float32 ``cos``/``sin`` as the float64 ones rounded, the port's
  definitions; see ``tests/test_torch_lensfile_solve.py``): ``trace_stack``,
  ``iris_c1_probe``, ``build_lut`` and ``build_precheck`` are bit-equal, down
  to the pre-check's form, its polynomial and the per-key acceptance;
* against the jitted JAX tracer as the compile runs it (XLA's own
  ``rsqrt``, fma contraction): ``ok`` and ``tir`` equal on every one of
  20,000 rays per lens and the surviving rays' origin and direction within
  1e-5;
* ``dead_film_fraction`` exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zoic_tpu import pupil as jp
from zoic_tpu import trace as jt
from zoic_tpu.io import state as jax_state_io
from zoic_tpu.optics import V3 as JV3

import zoic_tpu_torch as zpt
from zoic_tpu_torch import pupil as tp
from zoic_tpu_torch import trace as tt
from zoic_tpu_torch.optics import V3 as TV3

# the headline (iris, LUT), the fisheye (12 elements, harmonic bound), the
# iris-less telephoto and the headline lens without the LUT
CAMERAS = ["headline", "raytraced_fisheye",
           "raytraced_telephoto_f5.0_focus100", "raytraced_naive"]
N_RAYS = 20_000
R_MAX = 3.6 * 0.5 * np.sqrt(2.0)


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


def _lenses(camera):
    path = zpt.data.state_path(camera)
    return (jax_state_io.load(path).lens,
            zpt.load_state(path, device="cpu").lens)


def _rays(jlens, n, seed):
    """Film points over the film square's circumradius aimed at the whole
    first element (the naive cover): live, culled and TIR rays alike."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(0.0, R_MAX, n).astype(np.float32)
    ap = np.float32(jlens.aperture[0])
    px = rng.uniform(-1, 1, n).astype(np.float32) * ap
    py = rng.uniform(-1, 1, n).astype(np.float32) * ap
    oz = np.full(n, np.float32(jlens.origin_shift), np.float32)
    dz = np.full(n, -np.float32(jlens.thickness[0]), np.float32)
    zero = np.zeros(n, np.float32)
    return (r, zero, oz), (px - r, py, dz)


def _both(arrays):
    return (JV3(*(jnp.asarray(a) for a in arrays)),
            TV3(*(torch.from_numpy(a) for a in arrays)))


@pytest.mark.parametrize("mode", ["op_by_op", "jitted"])
@pytest.mark.parametrize("camera", CAMERAS)
def test_trace_stack_matches_jax(camera, mode, request):
    jlens, tlens = _lenses(camera)
    (jo, to), (jd, td) = (_both(a) for a in _rays(jlens, N_RAYS, 3))
    if mode == "op_by_op":
        request.getfixturevalue("op_by_op")
        ref = jt.trace_stack(jlens, jo, jd)
    else:
        ref = jax.jit(jt.trace_stack)(jlens, jo, jd)
    got = tt.trace_stack(tlens, to, td)
    ok, tir = np.asarray(ref.ok), np.asarray(ref.tir)
    np.testing.assert_array_equal(got.ok.numpy(), ok)
    np.testing.assert_array_equal(got.tir.numpy(), tir)
    assert 0 < ok.sum() < N_RAYS
    for g, r in zip((*got.origin, *got.direction),
                    (*ref.origin, *ref.direction)):
        if mode == "op_by_op":
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        else:
            np.testing.assert_allclose(g.numpy()[ok], np.asarray(r)[ok],
                                       rtol=0, atol=1e-5)


def test_iris_probe_bit_equal_op_by_op(op_by_op):
    jlens, tlens = _lenses("headline")
    (jo, to), (jd, td) = (_both(a) for a in _rays(jlens, 2048, 4))
    jc1, jreached = jt.iris_c1_probe(jlens, jo, jd)
    tc1, treached = tt.iris_c1_probe(tlens, to, td)
    np.testing.assert_array_equal(treached.numpy(), np.asarray(jreached))
    np.testing.assert_array_equal(tc1.numpy(), np.asarray(jc1))
    assert treached.any() and float(tc1[treached].min()) > 0.0
    _, tele = _lenses("raytraced_telephoto_f5.0_focus100")
    with pytest.raises(ValueError, match="aperture element"):
        tt.iris_c1_probe(tele, to, td)


@pytest.mark.parametrize("camera", ["headline", "raytraced_fisheye"])
def test_build_lut_bit_equal_op_by_op(camera, op_by_op):
    jlens, tlens = _lenses(camera)
    u = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (2, 32, 4096),
                                      dtype=jnp.float32))
    ref = jp.build_lut(jlens, None, 32, 4096, uniforms=jnp.asarray(u))
    got = tp.build_lut(tlens, 32, 4096, uniforms=u)
    for f in ("keys", "max_scale", "centroid_x", "bbox_min_x", "bbox_min_y",
              "bbox_max_x", "bbox_max_y"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    # the lookups on both sides of every key
    d = np.linspace(0.0, 4.0, 257, dtype=np.float32)
    for g, r in zip(tp.lut_lookup(got, torch.from_numpy(d)),
                    jp.lut_lookup(ref, jnp.asarray(d))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def _cover_uniforms(n):
    key = jax.random.PRNGKey(1)
    draw = lambda k, shape: np.asarray(  # noqa: E731
        jax.random.uniform(k, shape, dtype=jnp.float32))
    return {"cover_fit": draw(key, (2, 32, n)),
            "cover_held": draw(jax.random.fold_in(key, 1), (2, 32, n)),
            "cover_mid": draw(jax.random.fold_in(key, 2), (2, 31, n // 2))}


@pytest.mark.parametrize("camera,domain", [
    ("headline", "disk"), ("raytraced_fisheye", "disk"),
    ("raytraced_naive", "disk"), ("raytraced_bokeh_image", "square")])
def test_build_precheck_bit_equal_op_by_op(camera, domain, op_by_op):
    """The JAX function draws its covers from PRNGKey(1) and its fold-ins;
    the port takes the same arrays as ``uniforms``.  4,096 samples per key:
    the fits, held-out loosening, form choice and polynomial all run."""
    jlens, tlens = _lenses(camera)
    n = 4096
    jprof, jacc, jdef = jp.build_precheck(
        dataclasses.replace(jlens, profile=None), jax.random.PRNGKey(1),
        n_samples=n, domain=domain, r_max=R_MAX)
    tprof, tacc, tdef = tp.build_precheck(
        dataclasses.replace(tlens, profile=None), n, domain=domain,
        r_max=R_MAX, uniforms=_cover_uniforms(n))
    assert tprof.kind == jprof.kind
    assert tdef == jdef
    assert (tdef < tp.POLY_MAX_DEFICIT) == (jdef < jp.POLY_MAX_DEFICIT)
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
    for f in ("keys", "c0", "c1", "c2", "c4", "poly", "poly_scale"):
        np.testing.assert_array_equal(getattr(tprof, f).numpy(),
                                      np.asarray(getattr(jprof, f)),
                                      err_msg=f)
    assert (tp.dead_film_fraction(tprof.keys, tacc, R_MAX)
            == jp.dead_film_fraction(jprof.keys, jacc, R_MAX))


def test_fit_precheck_poly_matches_jax():
    """Both branches of the kind dispatch on the shipped profiles: the
    harmonic fisheye's analytic-uplift fit and the circles' gate-off."""
    for camera in ("raytraced_fisheye", "headline"):
        jlens, tlens = _lenses(camera)
        jpoly, jscale, jdef = jp.fit_precheck_poly(jlens.profile, r_max=R_MAX)
        tpoly, tscale, tdef = tp.fit_precheck_poly(tlens.profile, r_max=R_MAX)
        assert tdef == jdef
        np.testing.assert_array_equal(tpoly.numpy(), np.asarray(jpoly))
        np.testing.assert_array_equal(tscale.numpy(), np.asarray(jscale))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dead_film_fraction_exact(seed):
    rng = np.random.default_rng(seed)
    keys = (np.arange(32) * 0.125).astype(np.float32)
    acc = rng.uniform(0.0, 0.1, 32).astype(np.float32)
    acc[rng.integers(0, 32, 5)] = 0.0
    got = tp.dead_film_fraction(torch.from_numpy(keys), torch.from_numpy(acc),
                                R_MAX)
    assert got == jp.dead_film_fraction(jnp.asarray(keys), jnp.asarray(acc),
                                        R_MAX)
    assert 0.0 < got < 1.0
