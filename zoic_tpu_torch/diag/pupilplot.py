"""Exit-pupil sampling comparison: ground truth vs LUT-shaped point clouds.

Port of ``zoic_tpu/diag/pupilplot.py``, the reference's aperture self-test
(``testAperturesTruth`` zoic.cpp:1354-1388, ``testAperturesLUT``
zoic.cpp:1458-1544, rendered by ``src/triangleSamplingDraw.py``): for a grid
of film positions, (a) fire rays at the whole first element and keep the
lens-UV points whose full trace survives (the true exit pupil), and (b) draw
LUT-shaped samples; plot both and their overlay per film position.  The
visual overlap is the reference's LUT correctness test; the data is also
returned for quantitative coverage checks.

The traces run eagerly on the lens's device.  The JAX package draws from a
``jax.random`` key split in a chain; here each function takes a
``torch.Generator`` on the lens's device (one seeded ``seed`` when none is
given) or, for one film position, ``uniforms``: a ``[2, n]`` array used as
drawn.  matplotlib is imported by :func:`render_comparison` only.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import pupil, trace
from ..optics import V3
from ..sampling import concentric_disk_sample
from ..system import LensSystem
from . import dump as dump_mod

Tensor = torch.Tensor


def _generator(lens: LensSystem, generator: Optional[torch.Generator],
               seed: int) -> torch.Generator:
    if generator is not None:
        return generator
    return torch.Generator(device=lens.ior.device).manual_seed(seed)


def _draw(lens: LensSystem, n: int, generator, uniforms, seed: int) -> Tensor:
    """U[0, 1) float32 ``[2, n]`` on the lens's device: ``uniforms`` when
    given, else drawn from the generator."""
    if uniforms is None:
        generator = _generator(lens, generator, seed)
    return pupil.draw_uniforms(
        None if uniforms is None else {"pupil": uniforms}, "pupil", (2, n),
        generator, lens.ior.device)


def _film_grid(film_grid: int, sensor_width: float):
    """The self-test's film positions ``(i, j, x, y)``, column by column
    (zoic.cpp:1360-1362)."""
    for i in range(-film_grid, film_grid + 1):
        for j in range(-film_grid, film_grid + 1):
            yield (i, j, (i / film_grid) * (sensor_width * 0.5),
                   (j / film_grid) * (sensor_width * 0.5))


def ground_truth_pupil(
    lens: LensSystem,
    film_xy: Tuple[float, float],
    n_samples: int = 10_000,
    *,
    generator: Optional[torch.Generator] = None,
    uniforms=None,
    seed: int = 0,
) -> np.ndarray:
    """Surviving first-element target points for one film position
    (``testAperturesTruth`` semantics: concentric-disk over the whole first
    element; the reference uses the element *diameter* as the scale,
    zoic.cpp:1374-1376).  Returns ``[N, 2]`` numpy."""
    u = _draw(lens, n_samples, generator, uniforms, seed)
    dev = u.device
    lx, ly = concentric_disk_sample(u[0], u[1])
    px = lx * lens.aperture[0]
    py = ly * lens.aperture[0]
    ox = torch.full((n_samples,), film_xy[0], dtype=torch.float32, device=dev)
    oy = torch.full((n_samples,), film_xy[1], dtype=torch.float32, device=dev)
    zeros = torch.zeros((n_samples,), dtype=torch.float32, device=dev)
    oz = zeros + lens.origin_shift
    d = V3(px - ox, py - oy, zeros - lens.thickness[0])
    ok = trace.trace_stack(lens, V3(ox, oy, oz), d).ok
    return torch.stack([px[ok], py[ok]], -1).cpu().numpy()


def lut_samples(
    lens: LensSystem,
    film_xy: Tuple[float, float],
    n_samples: int = 5_000,
    *,
    generator: Optional[torch.Generator] = None,
    uniforms=None,
    seed: int = 0,
) -> np.ndarray:
    """LUT-shaped sample points for one film position
    (``testAperturesLUT`` semantics, zoic.cpp:1475-1530).  Returns
    ``[n_samples, 2]`` numpy."""
    u = _draw(lens, n_samples, generator, uniforms, seed)
    lx, ly = concentric_disk_sample(u[0], u[1])
    fx = torch.full((n_samples,), film_xy[0], dtype=torch.float32,
                    device=u.device)
    fy = torch.full((n_samples,), film_xy[1], dtype=torch.float32,
                    device=u.device)
    px, py = pupil.shape_sample(lens.lut, lx, ly, fx, fy)
    return torch.stack([px, py], -1).cpu().numpy()


def coverage(
    lens: LensSystem,
    film_xy: Tuple[float, float],
    n: int = 10_000,
    *,
    generator: Optional[torch.Generator] = None,
    uniforms=None,
    seed: int = 0,
) -> float:
    """Fraction of ground-truth pupil points inside the LUT sampling disk:
    should be ~1.0 (the LUT cover must contain the pupil)."""
    gt = ground_truth_pupil(lens, film_xy, n, generator=generator,
                            uniforms=uniforms, seed=seed)
    if len(gt) == 0:
        return 1.0
    dist = float(np.hypot(*film_xy))
    ms, tr_ = pupil.lut_lookup(
        lens.lut, torch.tensor(dist, dtype=torch.float32,
                               device=lens.ior.device))
    ms = float(ms)
    cx = float(tr_)
    theta = np.arctan2(film_xy[1], film_xy[0])
    c, s = np.cos(theta), np.sin(theta)
    center = np.array([cx * c, cx * s])
    r = np.linalg.norm(gt - center, axis=1)
    return float(np.mean(r <= ms * 1.0000001))


def render_comparison(
    lens: LensSystem,
    out_path: str,
    film_grid: int = 3,
    sensor_width: float = 3.6,
    seed: int = 0,
    dpi: int = 110,
    n_gt: int = 4000,
    n_ss: int = 2000,
    *,
    generator: Optional[torch.Generator] = None,
) -> None:
    """(2*film_grid+1)^2 panel plot: GT pupil (blue), LUT samples (orange),
    overlay: the reference's three-section comparison image.  Each panel
    draws its ground truth, then its samples, from one generator."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    g = _generator(lens, generator, seed)
    n = 2 * film_grid + 1
    fig, axes = plt.subplots(n, n, figsize=(2.2 * n, 2.2 * n), dpi=dpi)
    for i, j, fx, fy in _film_grid(film_grid, sensor_width):
        ax = axes[film_grid - j][i + film_grid]
        gt = ground_truth_pupil(lens, (fx, fy), n_gt, generator=g)
        ss = lut_samples(lens, (fx, fy), n_ss, generator=g)
        if len(gt):
            ax.plot(gt[:, 0], gt[:, 1], ".", ms=0.7, color="#3377cc", alpha=0.5)
        ax.plot(ss[:, 0], ss[:, 1], ".", ms=0.7, color="#e08833", alpha=0.35)
        ax.set_aspect("equal")
        ax.set_xticks([])
        ax.set_yticks([])
        ax.set_title(f"({fx:.1f},{fy:.1f})", fontsize=6)
    fig.suptitle("exit pupil: ground truth (blue) vs LUT cover (orange)")
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)


def write_selftest_dump(
    lens: LensSystem,
    path: str,
    film_grid: int = 3,
    sensor_width: float = 3.6,
    n_gt: int = 10_000,
    n_ss: int = 5_000,
    seed: int = 0,
    *,
    generator: Optional[torch.Generator] = None,
) -> None:
    """Produce a ``testApertures.zoic`` artifact like the reference's
    aperture self-test (testAperturesTruth zoic.cpp:1354-1388 writes GT rows
    over a (2*film_grid+1)^2 film grid at 3.6*0.5 spacing; testAperturesLUT
    zoic.cpp:1458-1537 writes SS rows): the interchange format of the
    reference's triangleSamplingDraw.py renderer.  Every GT row is drawn
    before the first SS row, from one generator."""
    g = _generator(lens, generator, seed)
    grid = list(_film_grid(film_grid, sensor_width))
    gt_rows = [ground_truth_pupil(lens, (fx, fy), n_gt, generator=g)
               for _, _, fx, fy in grid]
    ss_rows = [lut_samples(lens, (fx, fy), n_ss, generator=g)
               for _, _, fx, fy in grid]
    dump_mod.write_aperture_test(path, gt_rows, ss_rows)
