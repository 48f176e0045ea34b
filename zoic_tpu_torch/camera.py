"""Top-level camera API of the port: batched ray generation.

Counterpart of ``zoic_tpu.camera.create_rays`` for the RAYTRACED model on
a state compiled by the JAX package (:func:`zoic_tpu_torch.load_state`).
Configurations outside the ported slice raise ``NotImplementedError``
naming the ROADMAP item that ports them.  The lens-compile pipeline
(``compile_camera``) and the ``Camera`` wrapper are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .config import CameraConfig, LensModel
from .models import raytraced
from .system import CameraState, RayBatch, RayStats

Tensor = torch.Tensor


def _check_slice(config: CameraConfig) -> None:
    """Config-level gates; lens-state gates live with the kernel
    (``ops.trace_kernel.check_supported``)."""
    if config.lens_model is LensModel.THINLENS:
        raise NotImplementedError(
            "THINLENS model: ROADMAP Queue 1 item 2 (thin-lens model)"
        )
    if config.use_image:
        raise NotImplementedError(
            "use_image: ROADMAP Queue 1 item 3 (image bokeh)"
        )
    if not config.kolb_sampling_lut:
        raise NotImplementedError(
            "kolb_sampling_lut=False (naive first-element shaping): "
            "ROADMAP Queue 1 item 1 (raytraced variants)"
        )
    if not config.pupil_precheck:
        raise NotImplementedError(
            "pupil_precheck=False: ROADMAP Queue 1 item 1 (raytraced "
            "variants)"
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
    required.  Returns ``(RayBatch, RayStats)``."""
    _check_slice(config)
    dev = state.device
    sx, sy, lensx, lensy = (
        torch.as_tensor(a, dtype=torch.float32, device=dev)
        for a in (sx, sy, lensx, lensy)
    )
    return raytraced.create_rays(
        state, config, sx, sy, lensx, lensy, seed=seed, generator=generator
    )
