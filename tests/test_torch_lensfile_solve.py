"""The port's lens files, lens parser, optics and lens solve against the JAX
package's.

* The port's ``data/lenses/*.dat`` are byte copies of the JAX package's, and
  its lens table names the same designs.
* ``zoic_tpu_torch.lensfile`` parses every lens into arrays equal to
  ``zoic_tpu.lensfile``'s (both are numpy float32).
* ``solve_lens`` op by op: under ``jax.disable_jit`` with ``jax.lax.rsqrt``
  taken as ``1 / sqrt``, every derived quantity and every solved array is
  bit-equal.  The port's rsqrt is ``1 / sqrt``, both correctly rounded, on
  every device; XLA's CPU ``rsqrt`` is an approximation 1 ulp off on about
  one input in seven, so against the real JAX package the last bits part.
* ``solve_lens`` against the jitted JAX package (its ``rsqrt`` and its fma
  contraction): every derived quantity within 2e-5 relative (measured at
  most 1.2e-5, the principal planes of petzval_f1.6, whose lines meet at a
  shallow angle; the state's scalars at most 2.6e-6).
* A handful of ``tests/test_optics.py``'s primitives on shared random
  inputs, op by op as above: bit-equal.
"""

import filecmp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zoic_tpu as zt
from zoic_tpu import lensfile as jlf
from zoic_tpu import optics as jo
from zoic_tpu import solve as js

import zoic_tpu_torch as zpt
from zoic_tpu_torch import lensfile as tlf
from zoic_tpu_torch import optics as to
from zoic_tpu_torch import solve as ts

LENSES = sorted(zt.data.LENSES)
REPORT = ("traced_focal_length_raw", "principal_plane_raw", "focal_point_raw",
          "focal_length_ratio", "traced_focal_length", "principal_plane",
          "focal_point", "user_aperture_radius", "image_distance",
          "aperture_distance")
ARRAYS = ("curvature", "thickness", "ior", "abbe", "aperture", "center",
          "user_aperture_radius", "origin_shift", "aperture_distance",
          "focal_length_ratio", "traced_focal_length", "film_diagonal",
          "focal_distance")
JIT_RTOL = 2e-5


@pytest.fixture
def op_by_op(monkeypatch):
    """Run the JAX package eagerly with ``rsqrt`` as ``1 / sqrt``."""
    monkeypatch.setattr(jax.lax, "rsqrt", lambda x: 1.0 / jnp.sqrt(x))
    with jax.disable_jit():
        yield


@pytest.mark.parametrize("name", LENSES)
def test_lens_copies_are_byte_equal(name):
    assert filecmp.cmp(zpt.data.lens_path(name), zt.data.lens_path(name),
                       shallow=False)
    got, ref = zpt.data.LENSES[name], zt.data.LENSES[name]
    assert (got.name, got.efl_mm, got.bfl_mm, got.fstop, got.elements) == (
        ref.name, ref.efl_mm, ref.bfl_mm, ref.fstop, ref.elements)
    assert sorted(zpt.data.LENSES) == LENSES


@pytest.mark.parametrize("name", LENSES)
def test_parse_matches_jax(name):
    raw_t = tlf.parse(zpt.data.lens_path(name))
    raw_j = jlf.parse(zt.data.lens_path(name))
    got, ref = tlf.cleanup(raw_t), jlf.cleanup(raw_j)
    for a, b in ((raw_t, raw_j), (got, ref)):
        assert a.aperture_element == b.aperture_element
        for f in ("curvature", "thickness", "ior", "abbe", "aperture"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype == np.float32, f
            np.testing.assert_array_equal(x, y, err_msg=f)
    assert got.count == zt.data.LENSES[name].elements
    with pytest.raises(tlf.LensFileError):
        tlf.load(zpt.data.lens_path(name) + ".missing")


def _configs(focal_distance):
    kw = dict(lens_data_path="unused", focal_length=5.0, fstop=2.0,
              focal_distance=focal_distance)
    return zt.CameraConfig(**kw), zpt.CameraConfig(**kw)


@pytest.mark.parametrize("name", LENSES)
def test_solve_bit_equal_op_by_op(name, op_by_op):
    jcfg, tcfg = _configs(100.0)
    jlens, jrep = js.solve_lens(jlf.load(zt.data.lens_path(name)), jcfg)
    tlens, trep = ts.solve_lens(tlf.load(zpt.data.lens_path(name)), tcfg,
                                "cpu")
    for k in REPORT:
        assert trep[k].dtype == torch.float32, k
        assert trep[k].numpy().tobytes() == np.asarray(jrep[k]).tobytes(), k
    for f in ARRAYS:
        np.testing.assert_array_equal(getattr(tlens, f).numpy(),
                                      np.asarray(getattr(jlens, f)),
                                      err_msg=f)
    assert tlens.aperture_element == jlens.aperture_element


@pytest.mark.parametrize("focal_distance", [30.0, 1000.0])
@pytest.mark.parametrize("name", LENSES)
def test_solve_matches_jitted_jax(name, focal_distance):
    jcfg, tcfg = _configs(focal_distance)
    _, jrep = js.solve_lens(jlf.load(zt.data.lens_path(name)), jcfg)
    _, trep = ts.solve_lens(tlf.load(zpt.data.lens_path(name)), tcfg, "cpu")
    for k in REPORT:
        np.testing.assert_allclose(trep[k].numpy(), np.asarray(jrep[k]),
                                   rtol=JIT_RTOL, atol=0, err_msg=k)


def _rand(rng, n, lo, hi):
    return rng.uniform(lo, hi, n).astype(np.float32)


def _pair(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


def _case_inputs(rng, n=4096):
    """Rays from near the film towards a sphere of radius 2 at z = 3, and a
    unit-ish normal field: the shapes the lens trace meets."""
    o = [_rand(rng, n, -0.5, 0.5), _rand(rng, n, -0.5, 0.5),
         _rand(rng, n, -0.2, 0.2)]
    d = [_rand(rng, n, -0.3, 0.3), _rand(rng, n, -0.3, 0.3),
         _rand(rng, n, 0.8, 1.2)]
    return o, d


def _optics_case(case, mod, V3, arrays, scalars):
    (ox, oy, oz, dx, dy, dz, t), (cz, r, n1, n2) = arrays, scalars
    o, d = V3(ox, oy, oz), V3(dx, dy, dz)
    if case == "fast_sin":
        return (mod.fast_sin(t),)
    if case == "fast_cos":
        return (mod.fast_cos(t),)
    if case.startswith("intersect"):
        hit, miss = mod.ray_sphere_intersect(
            o, d, cz, r, reverse="reverse" in case, cull_miss="cull" in case)
        return (*hit, miss)
    if case == "normal":
        return tuple(mod.sphere_normal(o, cz, r))
    if case.startswith("refract"):
        out, tir = mod.refract(d, o, n1, n2, check_tir=case == "refract_tir")
        return (*out, tir)
    if case == "line_plane_y0":
        return tuple(mod.line_plane_y0(o, d))
    if case == "line_line_zy":
        return mod.line_line_zy(o, d, V3(dx, oy, ox), V3(oz, dz, dy))
    raise ValueError(case)


@pytest.mark.parametrize("case", [
    "fast_sin", "fast_cos", "intersect", "intersect_reverse",
    "intersect_cull", "intersect_cull_reverse", "normal", "refract",
    "refract_tir", "line_plane_y0", "line_line_zy"])
def test_optics_bit_equal_op_by_op(case, op_by_op):
    rng = np.random.default_rng(sum(map(ord, case)))
    o, d = _case_inputs(rng)
    t = _rand(rng, 4096, -np.pi, 3 * np.pi)
    jarr, tarr = _pair(*o, *d, t)
    # a negative radius picks the near surface; 1.7 -> 1.0 can totally
    # internally reflect
    scal = (np.float32(3.0), np.float32(-2.0), np.float32(1.7),
            np.float32(1.0))
    jsc = [jnp.float32(s) for s in scal]
    tsc = [torch.tensor(s) for s in scal]
    ref = _optics_case(case, jo, jo.V3, jarr, jsc)
    got = _optics_case(case, to, to.V3, tarr, tsc)
    for i, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r),
                                      err_msg=f"output {i}")
    if case == "refract_tir":
        assert got[-1].any() and not got[-1].all()
