"""The plain reference's camera compile: the ``node_update`` pipeline
(zoic.cpp:1575-1720) worked out again from the lens file and the compile's
Monte-Carlo draws, with the frozen copies beside this file.

It follows ``zoic_tpu_torch/camera.py`` (``_iris_identity``,
``_compile_lens``, ``compile_camera``) step for step, on plain PyTorch and
NumPy, and takes nothing the port built: the benchmark hands both sides
the same lens file, the same draws and the same bokeh image.  ``cam`` is
any object with the camera's fields (the config file's ``camera`` block,
see :func:`camera_fields`).
"""

from __future__ import annotations

import dataclasses
import math
from types import SimpleNamespace
from typing import Mapping, Optional

import numpy as np
import torch

from . import bokeh, lensfile, pupil, solve, trace
from .optics import V3
from .system import CameraState, LensSystem

# the camera fields and their defaults (the reference node's parameters,
# zoic.cpp:1547-1562, and the port's compile knobs)
DEFAULTS = dict(
    sensor_width=3.6, sensor_height=2.4, focal_length=2.0, fstop=4.0,
    focal_distance=100.0, use_image=False, lens_model="RAYTRACED",
    kolb_sampling_lut=True, use_dof=True, optical_vignetting_distance=0.0,
    optical_vignetting_radius=1.0, exposure_control=0.0, max_tries=25,
    pupil_precheck=True, lut_film_samples=32, lut_bounds_samples=100_000,
)


def camera_fields(camera: Mapping) -> SimpleNamespace:
    """The camera block of a configuration file with the defaults filled
    in; unknown keys (the lens file, the bokeh image) are kept as given."""
    return SimpleNamespace(**{**DEFAULTS, **camera})


def uniform_shapes(cam) -> dict:
    """Shapes of the compile's draws by name, in the order the RAYTRACED
    compile draws them."""
    n_film, n_samples = cam.lut_film_samples, cam.lut_bounds_samples
    n_keys = n_film if cam.kolb_sampling_lut else 32
    n = 50_000
    return {"iris_probe": (2, 32, 2048), "lut": (2, n_film, n_samples),
            "cover_fit": (2, n_keys, n), "cover_held": (2, n_keys, n),
            "cover_mid": (2, n_keys - 1, n // 2)}


def _iris_identity(lens: LensSystem, cam, pu) -> bool:
    ae = lens.aperture_element
    ior = lens.ior.tolist()
    if not (ae >= 0 and ior[ae] == (ior[1:] + [1.0])[ae]):
        return False
    n_r, n_s = 32, 2048
    dev = lens.ior.device
    r_corner = math.hypot(cam.sensor_width, cam.sensor_height) * 0.5
    fx = torch.linspace(0.0, r_corner, n_r, dtype=torch.float32,
                        device=dev)[:, None].expand(n_r, n_s)
    zeros = torch.zeros_like(fx)
    px = (pu[0] * 2.0 - 1.0) * lens.aperture[0]
    py = (pu[1] * 2.0 - 1.0) * lens.aperture[0]
    c1p, reached = trace.iris_c1_probe(
        lens, V3(fx, zeros, zeros + lens.origin_shift),
        V3(px - fx, py, zeros - lens.thickness[0]),
    )
    min_c1 = float(torch.where(reached, c1p, float("inf")).min())
    return min_c1 > 0.0


def compile_lens(cam, lens_path: str, device, uniforms: Mapping) -> LensSystem:
    """The RAYTRACED half of ``node_update``: parse, solve, element flags,
    the iris probe, the exit-pupil LUT and the pupil pre-check."""
    u = {k: v.to(device=device, dtype=torch.float32) for k, v in uniforms.items()}
    rx = lensfile.load(lens_path)
    lens, _ = solve.solve_lens(rx, cam, device)
    ior = lens.ior.tolist()
    flags = tuple(
        (1 if a > b else 0) | (2 if c < 0.0 else 0)
        for a, b, c in zip(ior, ior[1:] + [1.0], lens.curvature.tolist())
    )
    lens = dataclasses.replace(
        lens, elem_flags=flags,
        iris_identity=_iris_identity(lens, cam, u["iris_probe"]))
    if cam.kolb_sampling_lut:
        lens = dataclasses.replace(lens, lut=pupil.build_lut(
            lens, cam.lut_film_samples, cam.lut_bounds_samples,
            uniforms=u["lut"]))
    if cam.pupil_precheck:
        domain = "square" if cam.use_image else "disk"
        r_max = cam.sensor_width * 0.5 * math.sqrt(2.0)
        covers = {k: u[k] for k in ("cover_fit", "cover_held", "cover_mid")}
        profile, key_acc, deficit = pupil.build_precheck(
            lens, 50_000, domain=domain, r_max=r_max, uniforms=covers)
        dead = pupil.dead_film_fraction(profile.keys, key_acc, r_max)
        lens = dataclasses.replace(
            lens, profile=profile, dead_frac=round(dead, 1),
            profile_domain=domain,
            profile_poly=bool(deficit < pupil.POLY_MAX_DEFICIT),
        )
    return lens


def compile_camera(cam, device, *, lens_path: Optional[str] = None,
                   uniforms: Optional[Mapping] = None,
                   bokeh_pixels: Optional[np.ndarray] = None) -> CameraState:
    """The whole camera state on ``device``: the thin-lens scalars in
    Python doubles rounded to float32, the lens compile for RAYTRACED, the
    bokeh tables when ``cam.use_image``."""
    dev = torch.device(device)
    lens = None
    if cam.lens_model == "RAYTRACED":
        lens = compile_lens(cam, lens_path, dev, uniforms)
    fov = 2.0 * math.atan(cam.sensor_width / (2.0 * cam.focal_length))

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    image = None
    if cam.use_image:
        image = bokeh.build(bokeh_pixels).to(dev)
    return CameraState(
        fov=f32(fov), tan_fov=f32(math.tan(fov / 2.0)),
        aperture_radius=f32(cam.focal_length / (2.0 * cam.fstop)),
        sensor_width=f32(cam.sensor_width),
        sensor_height=f32(cam.sensor_height),
        focal_distance=f32(cam.focal_distance),
        ov_distance=f32(cam.optical_vignetting_distance),
        ov_radius=f32(cam.optical_vignetting_radius),
        exposure_control=f32(cam.exposure_control),
        lens=lens, bokeh=image,
    )
