"""Top-level camera API of the port: set-up and batched ray generation.

Counterparts of ``zoic_tpu.camera.compile_camera`` and
``zoic_tpu.camera.create_rays``.  The THINLENS model runs end to end in the
port: :func:`compile_camera` computes its three scalars and builds the
bokeh image on the host.  The RAYTRACED model runs, in every variant, on a
state compiled by the JAX package (:func:`zoic_tpu_torch.load_state`); its
lens-compile pipeline is not ported yet, so :func:`compile_camera` raises
``NotImplementedError`` for it, naming the ROADMAP item that ports it.  The
``Camera`` wrapper is not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from . import bokeh as bokeh_mod
from .config import CameraConfig, LensModel
from .models import raytraced, thinlens
from .system import CameraState, RayBatch, RayStats

Tensor = torch.Tensor


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


def compile_camera(config: CameraConfig, device="cpu") -> CameraState:
    """Build the camera state on ``device`` (the ``node_update`` pipeline,
    zoic.cpp:1606-1608) for the THINLENS model: fov, tan(fov/2) and the
    aperture radius in Python doubles, rounded to float32, and the bokeh
    image when ``use_image`` is set."""
    if config.lens_model is not LensModel.THINLENS:
        raise NotImplementedError(
            "compile_camera for RAYTRACED (the lens-compile pipeline): "
            "ROADMAP Queue 1 item 5 (compile pipeline); load a state the "
            "JAX package compiled with zoic_tpu_torch.load_state"
        )
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
        lens=None,
        bokeh=_load_bokeh(config),
    )
    return state.to(device)


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
    required.  Returns ``(RayBatch, RayStats)``."""
    dev = state.device
    sx, sy, lensx, lensy = (
        torch.as_tensor(a, dtype=torch.float32, device=dev)
        for a in (sx, sy, lensx, lensy)
    )
    if config.lens_model is LensModel.THINLENS:
        return thinlens.create_rays(state, config, sx, sy, lensx, lensy,
                                    seed=seed, generator=generator)
    return raytraced.create_rays(
        state, config, sx, sy, lensx, lensy, seed=seed, generator=generator
    )
