"""Top-level camera API of the port: set-up and batched ray generation.

Counterparts of ``zoic_tpu.camera.compile_camera`` and
``zoic_tpu.camera.create_rays``; both models run end to end without JAX.
:func:`compile_camera` computes the THINLENS scalars and builds the bokeh
image on the host, and for RAYTRACED runs the lens compile from the lens
file (parse, solve, the iris probe, the exit-pupil LUT and the pupil
pre-check) on the camera's device.  A state the JAX package compiled still
loads with :func:`zoic_tpu_torch.load_state`; the shipped ones are the
parity anchor of this compile.  The ``Camera`` wrapper is not ported yet
(ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Mapping, Optional, Tuple

import torch

from . import bokeh as bokeh_mod
from . import lensfile, pupil, solve, trace
from .config import CameraConfig, LensModel
from .models import raytraced, thinlens
from .optics import V3
from .system import CameraState, LensSystem, RayBatch, RayStats

log = logging.getLogger("zoic")

Tensor = torch.Tensor

# the names of the compile's uniform draws (compile_camera ``uniforms=``),
# in the order they are drawn from its generator
UNIFORM_NAMES = ("iris_probe", "lut", "cover_fit", "cover_held", "cover_mid")


def _load_bokeh(config: CameraConfig):
    """The bokeh sampler state (``imageData::read``, zoic.cpp:168), with the
    ``_DEBUGIMAGESAMPLING`` build dump when the config asks for it."""
    if not config.use_image:
        return None
    tr_path = config.debug.image_sampling_trace
    if tr_path:
        with open(tr_path, "w") as tr:
            return bokeh_mod.load(config.bokeh_path, trace=tr)
    return bokeh_mod.load(config.bokeh_path)


def _iris_identity(lens: LensSystem, config: CameraConfig, draw) -> bool:
    """The raytraced kernel's iris refract-identity skip (``camera.py:93-130``
    of the JAX package): ``eta == 1`` at the iris, machine-checked by a probe
    of the widest cover the camera can emit (naive first-element targeting
    from film radii up to the corner) for ``c1 > 0`` on every ray that
    reaches the iris."""
    ae = lens.aperture_element
    ior = lens.ior.tolist()
    if not (ae >= 0 and ior[ae] == (ior[1:] + [1.0])[ae]):
        return False
    n_r, n_s = 32, 2048
    dev = lens.ior.device
    r_corner = math.hypot(config.sensor_width, config.sensor_height) * 0.5
    pu = draw("iris_probe", (2, n_r, n_s))
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
    if not min_c1 > 0.0:
        log.warning("[ZOIC] iris refract-identity skip disabled: probe found "
                    "reached-iris ray with c1 = %g <= 0", min_c1)
        return False
    return True


def _compile_lens(config: CameraConfig, device, draw) -> LensSystem:
    """The RAYTRACED half of ``node_update`` (zoic.cpp:1615-1698): lens load
    and solve, the static kernel flags, the LUT and the pupil pre-check."""
    rx = lensfile.load(config.lens_data_path)
    lens, report = solve.solve_lens(rx, config, device)
    solve.log_report(report)
    # per-element flags: TIR possible (ior > next ior), negative curvature
    ior = lens.ior.tolist()
    flags = tuple(
        (1 if a > b else 0) | (2 if c < 0.0 else 0)
        for a, b, c in zip(ior, ior[1:] + [1.0], lens.curvature.tolist())
    )
    lens = dataclasses.replace(lens, elem_flags=flags,
                               iris_identity=_iris_identity(lens, config, draw))
    if config.kolb_sampling_lut:
        n_film, n_samples = config.lut_film_samples, config.lut_bounds_samples
        lens = dataclasses.replace(lens, lut=pupil.build_lut(
            lens, n_film, n_samples,
            uniforms=draw("lut", (2, n_film, n_samples))))
    if config.pupil_precheck:
        # image-bokeh offsets fill [-1, 1]^2 (bokehSample, zoic.cpp:441-485):
        # the bound is then fitted and validated over the square
        domain = "square" if config.use_image else "disk"
        r_max = config.sensor_width * 0.5 * math.sqrt(2.0)
        n_keys = lens.lut.keys.shape[0] if lens.lut is not None else 32
        n = 50_000
        covers = {name: draw(name, (2, k, m)) for name, k, m in (
            ("cover_fit", n_keys, n), ("cover_held", n_keys, n),
            ("cover_mid", n_keys - 1, n // 2))}
        profile, key_acc, deficit = pupil.build_precheck(
            lens, n, domain=domain, r_max=r_max, uniforms=covers)
        # dead-film fraction, quantized to one decimal as in the JAX package
        dead = pupil.dead_film_fraction(profile.keys, key_acc, r_max)
        lens = dataclasses.replace(
            lens, profile=profile, dead_frac=round(dead, 1),
            profile_domain=domain,
            profile_poly=bool(deficit < pupil.POLY_MAX_DEFICIT),
        )
    return lens


def compile_camera(
    config: CameraConfig,
    device="cuda",
    *,
    generator: Optional[torch.Generator] = None,
    uniforms: Optional[Mapping] = None,
) -> CameraState:
    """Build the camera state on ``device`` (the ``node_update`` pipeline,
    zoic.cpp:1575-1720).

    THINLENS: fov, tan(fov/2) and the aperture radius in Python doubles,
    rounded to float32, and the bokeh image when ``use_image`` is set.
    RAYTRACED: also the lens compile from ``config.lens_data_path`` on
    ``device``.  Its Monte-Carlo draws (:data:`UNIFORM_NAMES`: the iris
    probe ``(2, 32, 2048)``, the LUT ``(2, n_film, n_samples)``, the
    pre-check's fit and held-out covers ``(2, n_keys, 50000)`` and its
    midpoint cover ``(2, n_keys - 1, 25000)``) come from ``generator``, a
    ``torch.Generator`` on ``device`` seeded 0 when absent, or from
    ``uniforms``, a dict of those arrays by name."""
    dev = torch.device(device)
    unknown = sorted(set(uniforms or ()) - set(UNIFORM_NAMES))
    if unknown:
        raise ValueError(f"unknown uniforms {unknown}; names: {UNIFORM_NAMES}")
    lens = None
    if config.lens_model is LensModel.RAYTRACED:
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)

        def draw(name, shape):
            return pupil.draw_uniforms(uniforms, name, shape, generator, dev)

        lens = _compile_lens(config, dev, draw)
    fov = 2.0 * math.atan(config.sensor_width / (2.0 * config.focal_length))
    tan_fov = math.tan(fov / 2.0)
    aperture_radius = config.focal_length / (2.0 * config.fstop)

    def f32(x):
        return torch.tensor(x, dtype=torch.float32)

    state = CameraState(
        fov=f32(fov),
        tan_fov=f32(tan_fov),
        aperture_radius=f32(aperture_radius),
        sensor_width=f32(config.sensor_width),
        sensor_height=f32(config.sensor_height),
        focal_distance=f32(config.focal_distance),
        ov_distance=f32(config.optical_vignetting_distance),
        ov_radius=f32(config.optical_vignetting_radius),
        exposure_control=f32(config.exposure_control),
        lens=lens,
        bokeh=_load_bokeh(config),
    )
    return state.to(dev)


class Camera:
    """The stateful wrapper of ``zoic_tpu.Camera`` (caches, the
    ``update`` split, run stats, the draw session) is not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "zoic_tpu_torch.Camera (zoic_tpu/camera.py:212) is not ported: "
            "ROADMAP Queue 1 item 7; use compile_camera and create_rays"
        )


def create_rays(
    state: CameraState,
    config: CameraConfig,
    sx: Tensor,
    sy: Tensor,
    lensx: Tensor,
    lensy: Tensor,
    *,
    seed: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[RayBatch, RayStats]:
    """Map flat ``[B]`` (screen-UV, lens-UV) samples to rays.

    ``sx, sy`` span [-1, 1] and ``lensx, lensy`` [0, 1], all float32 on the
    state's device.  The retry draws are keyed by ``seed``, an int in
    ``[0, 2**22)``, or by one drawn from ``generator``; one of the two is
    required.  Strided inputs (columns of a ``[B, 2]`` sample tensor) are
    copied once here: the kernels read theirs in place.  Returns
    ``(RayBatch, RayStats)``."""
    dev = state.device
    sx, sy, lensx, lensy = (
        torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous()
        for a in (sx, sy, lensx, lensy)
    )
    if config.lens_model is LensModel.THINLENS:
        return thinlens.create_rays(state, config, sx, sy, lensx, lensy,
                                    seed=seed, generator=generator)
    return raytraced.create_rays(
        state, config, sx, sy, lensx, lensy, seed=seed, generator=generator
    )
