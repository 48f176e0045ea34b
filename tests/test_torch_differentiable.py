"""Differentiability of the port's lens pipeline, after
``tests/test_differentiable.py``: the eager trace and the focus solve are
tensor ops, so ``torch.autograd`` carries gradients through them to the
lens parameters.  On the Tessar f/2.8, with the same numpy uniforms on
both sides: finite, non-zero gradients; 25 normalised gradient steps halve
the spot RMS of a perturbed lens; d(image distance)/d(object distance) > 0;
and the spot RMS's gradient (``spot_rms`` of
``zoic_tpu_torch.examples.lens_optimization``) with respect to the
curvatures equals
``jax.grad``'s on the same lens (the port's compile, read by the JAX
package's state loader) within 1e-3 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zoic_tpu import sampling as j_sampling
from zoic_tpu import trace as j_trace
from zoic_tpu.io import state as jax_state_io
from zoic_tpu.optics import V3 as JV3

import zoic_tpu_torch as zpt
from zoic_tpu_torch import solve
from zoic_tpu_torch.examples.lens_optimization import spot_rms
from zoic_tpu_torch.io import state as state_io
from _torch_threads import one_thread  # noqa: F401

N = 1024


@pytest.fixture(scope="module")
def lenses(tmp_path_factory):
    cfg = zpt.CameraConfig(
        lens_model=zpt.LensModel.RAYTRACED,
        lens_data_path=zpt.data.lens_path("tessar_f2.8"),
        focal_length=5.0, fstop=2.8, focal_distance=100.0,
        kolb_sampling_lut=False, pupil_precheck=False)
    state = zpt.compile_camera(cfg, "cpu")
    path = str(tmp_path_factory.mktemp("tessar") / "tessar.npz")
    state_io.save(path, state)
    return state.lens, jax_state_io.load(path).lens


@pytest.fixture(scope="module")
def uniforms():
    return np.random.default_rng(0).uniform(size=(2, N)).astype(np.float32)


def _spot_rms_jax(lens, curvature, u):
    lens = dataclasses.replace(lens, curvature=curvature,
                               center=jnp.cumsum(lens.thickness) - curvature)
    lx, ly = j_sampling.concentric_disk_sample(u[0], u[1])
    px = lx * lens.user_aperture_radius * 2.0
    py = ly * lens.user_aperture_radius * 2.0
    z = jnp.zeros(u.shape[1])
    res = j_trace.trace_stack(lens, JV3(z, z, z + lens.origin_shift),
                              JV3(px, py, z - lens.thickness[0]))
    t = (lens.focal_distance - res.origin.z) / res.direction.z
    hx = res.origin.x + res.direction.x * t
    hy = res.origin.y + res.direction.y * t
    w = res.ok.astype(jnp.float32)
    return jnp.sqrt(jnp.sum((hx * hx + hy * hy) * w)
                    / jnp.maximum(jnp.sum(w), 1.0))


def _grad(lens, curvature, u):
    c = curvature.detach().clone().requires_grad_(True)
    loss = spot_rms(lens, c, torch.from_numpy(u))
    (g,) = torch.autograd.grad(loss, c)
    return float(loss.detach()), g


def test_grad_through_trace(lenses, uniforms):
    lens, _ = lenses
    _, g = _grad(lens, lens.curvature, uniforms)
    assert torch.isfinite(g).all()
    assert float(g.abs().max()) > 0.0


def test_grad_equals_jax_grad(lenses, uniforms):
    lens, jlens = lenses
    _, g = _grad(lens, lens.curvature, uniforms)
    gj = np.asarray(jax.grad(lambda c: _spot_rms_jax(jlens, c, jnp.asarray(
        uniforms)))(jlens.curvature))
    assert np.isfinite(gj).all()
    assert np.linalg.norm(g.numpy() - gj) <= 1e-3 * np.linalg.norm(gj)


def test_gradient_descent_refocuses(lenses, uniforms):
    lens, _ = lenses
    curv = lens.curvature.clone()
    curv[2] = curv[2] * 1.05
    loss0, _ = _grad(lens, curv, uniforms)
    for _ in range(25):
        _, g = _grad(lens, curv, uniforms)
        curv = curv - 2e-3 * g / (torch.linalg.norm(g) + 1e-9)
    loss1, _ = _grad(lens, curv, uniforms)
    assert loss1 < 0.5 * loss0


def test_grad_through_focus_solver(lenses):
    """The backwards focus solve is differentiable in the object distance:
    moving the object closer pushes the film plane away (more negative
    z)."""
    lens, _ = lenses
    rx = solve.Prescription(lens.curvature, lens.thickness, lens.ior,
                            lens.abbe, lens.aperture)
    od = torch.tensor(100.0, requires_grad=True)
    (g,) = torch.autograd.grad(solve.image_distance(rx, od), od)
    assert torch.isfinite(g) and float(g) > 0.0
