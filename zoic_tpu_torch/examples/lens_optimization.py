"""Differentiable lens design: optimise element geometry by gradient descent.

Counterpart of ``examples/lens_optimization.py``.  The whole eager trace
(:func:`zoic_tpu_torch.trace.trace_stack`) is tensor ops, so ray positions
are differentiable with respect to every lens parameter.  The Tessar f/2.8
gets +8% curvature on one surface, and Adam recovers its focus by
minimising the RMS spot radius at the focus distance: the classic
"autofocus by bending a surface" toy problem of differentiable optics.
``torch.optim.Adam`` takes the place of ``optax.adam`` (the same update,
rounded in another order), and the on-axis bundle's uniforms come from a
``torch.Generator`` seeded 0 in place of ``jax.random.PRNGKey(0)``.

    python -m zoic_tpu_torch.examples.lens_optimization [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional

import torch

from .. import data, trace
from ..camera import compile_camera
from ..config import CameraConfig, LensModel
from ..optics import V3
from ..sampling import concentric_disk_sample
from ..system import LensSystem

Tensor = torch.Tensor

LENS = "tessar_f2.8"
N_SAMPLES = 4096
STEPS = 60
LEARNING_RATE = 2e-3
# the perturbation: element 2's curvature times 1.08
PERTURBED_ELEMENT = 2
PERTURBATION = 1.08
REPORT_EVERY = 10


@dataclasses.dataclass
class Result:
    """One optimisation: the spot RMS (cm) of the designed and the
    perturbed lens, each step's loss (before its update), the optimised
    curvatures and their spot RMS."""

    designed: float
    perturbed: float
    losses: List[float]
    curvature: Tensor
    final: float

    @property
    def recovered(self) -> float:
        """The share of the perturbation's spot growth taken back."""
        return (self.perturbed - self.final) / (
            self.perturbed - self.designed + 1e-9)


def config() -> CameraConfig:
    """The example's camera: the Tessar at focal length 5 cm, f/2.8, focus
    100 cm, naive first-element sampling."""
    return CameraConfig(
        lens_model=LensModel.RAYTRACED,
        lens_data_path=data.lens_path(LENS),
        focal_length=5.0,
        fstop=2.8,
        focal_distance=100.0,
        kolb_sampling_lut=False,
    )


def uniforms(device, n: int = N_SAMPLES) -> Tensor:
    """The bundle's ``[2, n]`` uniforms, from a generator seeded 0 on
    ``device``."""
    g = torch.Generator(device=device).manual_seed(0)
    return torch.rand((2, n), generator=g, dtype=torch.float32,
                      device=device)


def spot_rms(lens: LensSystem, curvature: Tensor, u: Tensor) -> Tensor:
    """RMS radius of the on-axis spot at the focus distance, as a function
    of the element curvature vector, over the bundle drawn from the
    ``[2, n]`` uniforms ``u``."""
    lens = dataclasses.replace(
        lens,
        curvature=curvature,
        center=torch.cumsum(lens.thickness, 0) - curvature,
    )
    lx, ly = concentric_disk_sample(u[0], u[1])
    # target the iris region for a well-conditioned bundle
    px = lx * lens.user_aperture_radius * 2.0
    py = ly * lens.user_aperture_radius * 2.0
    ox = torch.zeros_like(u[0])
    oy = torch.zeros_like(u[0])
    oz = torch.zeros_like(u[0]) + lens.origin_shift
    d = V3(px - ox, py - oy, torch.zeros_like(u[0]) - lens.thickness[0])
    res = trace.trace_stack(lens, V3(ox, oy, oz), d)

    # propagate the exit rays to the focus distance: the traced state is
    # pre-negation (exit point on the front element, direction into the
    # scene), so the focused bundle crosses z = focal_distance
    t = (lens.focal_distance - res.origin.z) / res.direction.z
    hx = res.origin.x + res.direction.x * t
    hy = res.origin.y + res.direction.y * t
    w = res.ok.to(torch.float32)
    r2 = (hx * hx + hy * hy) * w
    return torch.sqrt(r2.sum() / torch.clamp_min(w.sum(), 1.0))


def perturbed(lens: LensSystem) -> Tensor:
    """The designed curvatures with the example's perturbation."""
    c = lens.curvature.clone()
    c[PERTURBED_ELEMENT] = c[PERTURBED_ELEMENT] * PERTURBATION
    return c


def optimize(lens: LensSystem, curvature: Tensor, u: Tensor,
             steps: int = STEPS):
    """``steps`` Adam steps on :func:`spot_rms` from ``curvature``.
    Returns the optimised curvatures and each step's loss, read back once
    at the end."""
    c = curvature.detach().clone().requires_grad_(True)
    opt = torch.optim.Adam([c], lr=LEARNING_RATE)
    losses = []
    for _ in range(steps):
        opt.zero_grad()
        loss = spot_rms(lens, c, u)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    return c.detach(), torch.stack(losses).tolist()


def run(device="cuda", steps: int = STEPS, lens: Optional[LensSystem] = None,
        u: Optional[Tensor] = None) -> Result:
    """The example: compile the Tessar on ``device`` (or take ``lens``),
    perturb it and optimise it for ``steps`` steps on the uniforms ``u``
    (:func:`uniforms` when absent)."""
    if lens is None:
        lens = compile_camera(config(), device).lens
    if u is None:
        u = uniforms(lens.ior.device)
    with torch.no_grad():
        designed = float(spot_rms(lens, lens.curvature, u))
        curv0 = perturbed(lens)
        loss0 = float(spot_rms(lens, curv0, u))
    curv, losses = optimize(lens, curv0, u, steps)
    with torch.no_grad():
        final = float(spot_rms(lens, curv, u))
    return Result(designed, loss0, losses, curv, final)


def main(argv=None) -> Result:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    r = run(args.device)
    print(f"spot RMS: designed {r.designed:.6f} cm | perturbed "
          f"{r.perturbed:.6f} cm")
    for i in range(0, len(r.losses), REPORT_EVERY):
        print(f"  step {i:3d}: spot RMS {r.losses[i]:.6f} cm")
    print(f"optimized spot RMS {r.final:.6f} cm (recovered "
          f"{r.recovered * 100:.0f}% of the perturbation)")
    return r


if __name__ == "__main__":
    main()
