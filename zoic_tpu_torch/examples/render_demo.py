"""Demo: a lens's vignetting, ray diagram and exit-pupil comparison through
the whole port.

Counterpart of ``examples/render_demo.py``.  For one lens of
:data:`zoic_tpu_torch.data.LENSES` it compiles a ``Camera`` (focal length
5 cm, the lens's f-stop, focus 100 cm, a 20,000-sample exit-pupil LUT and
the pupil pre-check), renders a frame with ``render.render_rays`` (the
raytraced kernel on the card), and writes into ``out_dir``:

* ``<lens>_vignetting.png``, the weight image (vignetting falloff);
* ``<lens>.zoic``, the ``draw.zoic`` dump of a ray tape, read back, and
  ``<lens>_diagram.png``, the ray diagram drawn from it;
* ``<lens>_pupil.png``, the exit pupil against the LUT's cover at
  ``(2 * film_grid + 1)^2`` film points, whose coverage it also prints.

The PNGs need matplotlib.  Where it is missing (as on a card machine
without it) the weight image is written as ``<lens>_vignetting.npy`` and
the demo says which PNGs it did not draw.  The JAX package's keys become
generators: the frame draws from one seeded 0, the tape from one seeded 1,
the pupil comparison from one seeded 0 and the coverage from one seeded 2.

    python -m zoic_tpu_torch.examples.render_demo [lens] [--out DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import data, render
from ..camera import Camera
from ..config import CameraConfig, LensModel
from ..diag import draw, dump, pupilplot, session, tape
from ..system import RayBatch, RayStats

Tensor = torch.Tensor

DEFAULT_LENS = "double_gauss_f2.0"
SPEC = render.FrameSpec(192, 128, spp=4)
LUT_BOUNDS_SAMPLES = 20_000
TAPE_SAMPLES = 4096
TAPE_STRIDE = 16
FILM_GRID = 2
COVERAGE_SAMPLES = 10_000
# the pupil comparison's film width (render_comparison's default)
SENSOR_WIDTH = 3.6


@dataclasses.dataclass
class DemoResult:
    """What :func:`run` computed: the camera, the frame's rays and stats,
    its ``[H, W]`` weight image (on the camera's device), the tape's
    ``[S, 4]`` segments, the dump's path, the coverage per film point, the
    files written, the PNGs not drawn, and the compile's seconds."""

    camera: Camera
    rays: RayBatch
    stats: RayStats
    image: Tensor
    segments: np.ndarray
    dump_path: str
    coverage: Dict[Tuple[float, float], float]
    written: List[str]
    not_drawn: List[str]
    compile_s: float


def config(lens_name: str = DEFAULT_LENS,
           lut_bounds_samples: int = LUT_BOUNDS_SAMPLES,
           **changes) -> CameraConfig:
    """The demo's camera for ``lens_name``."""
    return CameraConfig(
        lens_model=LensModel.RAYTRACED,
        lens_data_path=data.lens_path(lens_name),
        focal_length=5.0,
        fstop=data.LENSES[lens_name].fstop,
        focal_distance=100.0,
        lut_bounds_samples=lut_bounds_samples,
        **changes,
    )


def film_points():
    """The ``(x, y)`` film points of the pupil comparison, panel by panel."""
    return [(x, y) for _, _, x, y in pupilplot._film_grid(FILM_GRID,
                                                          SENSOR_WIDTH)]


def _seconds(fn, dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


def run(
    lens_name: str = DEFAULT_LENS,
    out_dir: str = "out",
    device="cuda",
    *,
    spec: render.FrameSpec = SPEC,
    lut_bounds_samples: int = LUT_BOUNDS_SAMPLES,
    pupil_precheck: bool = True,
    tape_uniforms=None,
    coverage_uniforms=None,
    generator: Optional[torch.Generator] = None,
) -> DemoResult:
    """The demo on ``device`` for ``lens_name``, files into ``out_dir``.

    ``generator`` draws the frame (one on ``device`` seeded 0 when absent);
    ``tape_uniforms`` are the tape's ``[4, n]`` uniforms (screen x, y, lens
    u, v; ``[4, 4096]`` from a generator seeded 1 when absent);
    ``coverage_uniforms`` are the coverage's ``[P, 2, n]`` uniforms, one
    ``[2, n]`` per film point of :func:`film_points` (``n`` = 10,000 from a
    generator seeded 2 when absent)."""
    os.makedirs(out_dir, exist_ok=True)
    dev = torch.device(device)
    cfg = config(lens_name, lut_bounds_samples, pupil_precheck=pupil_precheck)
    cam, compile_s = _seconds(lambda: Camera(cfg, dev), dev)
    written, not_drawn = [], []
    drawing = session.can_render()

    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    rays, stats = render.render_rays(cam.state, cfg, spec, generator)
    img = render.weight_image(spec, rays)
    png = os.path.join(out_dir, f"{lens_name}_vignetting.png")
    if drawing:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.imsave(png, img.cpu().numpy(), cmap="gray", vmin=0, vmax=1)
        written.append(png)
    else:
        npy = os.path.join(out_dir, f"{lens_name}_vignetting.npy")
        np.save(npy, img.cpu().numpy())
        written.append(npy)
        not_drawn.append(png)
    print(f"vignetted: {float(stats.vignetted_percent()):.1f}%  "
          f"tir: {int(stats.tir)}  -> {written[-1]}")

    if tape_uniforms is None:
        g = torch.Generator(device=dev).manual_seed(1)
        u = torch.rand((4, TAPE_SAMPLES), generator=g, dtype=torch.float32,
                       device=dev)
    else:
        u = torch.tensor(np.asarray(tape_uniforms), dtype=torch.float32,
                         device=dev)
    segs = tape.raytraced_tape(cam.state, cfg, u[0] * 2 - 1, u[1] * 2 - 1,
                               u[2], u[3], stride=TAPE_STRIDE)
    dump_path = os.path.join(out_dir, f"{lens_name}.zoic")
    dump.write(dump_path, cam.state.lens, segs)
    parsed = dump.parse_file(dump_path)
    written.append(dump_path)
    diagram = os.path.join(out_dir, f"{lens_name}_diagram.png")
    if drawing:
        draw.render(parsed, diagram)
        written.append(diagram)
    else:
        not_drawn.append(diagram)
    print(f"-> {written[-1]} ({segs.shape[0]} segments)")

    pupil_png = os.path.join(out_dir, f"{lens_name}_pupil.png")
    if drawing:
        pupilplot.render_comparison(cam.state.lens, pupil_png,
                                    film_grid=FILM_GRID)
        written.append(pupil_png)
        print(f"-> {pupil_png}")
    else:
        not_drawn.append(pupil_png)
    points = film_points()
    if coverage_uniforms is None:
        g = torch.Generator(device=dev).manual_seed(2)
        cover = {p: pupilplot.coverage(cam.state.lens, p, COVERAGE_SAMPLES,
                                       generator=g) for p in points}
    else:
        cover = {p: pupilplot.coverage(cam.state.lens, p, len(cu[0]),
                                       uniforms=cu)
                 for p, cu in zip(points, coverage_uniforms, strict=True)}
    print("exit-pupil coverage: " + ", ".join(
        f"({x:.1f},{y:.1f}) {c:.4f}" for (x, y), c in cover.items()))
    if not_drawn:
        print("matplotlib is not installed: did not draw "
              + ", ".join(not_drawn))

    cam.log_stats()
    return DemoResult(cam, rays, stats, img, segs, dump_path, cover, written,
                      not_drawn, compile_s)


def main(argv=None) -> DemoResult:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("lens", nargs="?", default=DEFAULT_LENS,
                    choices=sorted(data.LENSES))
    ap.add_argument("--out", default="out")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(args.lens, args.out, args.device)


if __name__ == "__main__":
    main()
