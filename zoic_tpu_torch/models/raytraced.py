"""Raytraced ("Kolb") camera model: the fused-kernel path.

Counterpart of ``zoic_tpu/models/raytraced.py:_create_rays_pallas``
without the image-bokeh branch.  The whole sample -> shape -> trace ->
retry pipeline runs in one kernel (:mod:`zoic_tpu_torch.ops.trace_kernel`);
the weight, exposure and derivative epilogue stays in PyTorch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..config import CameraConfig
from ..ops import trace_kernel
from ..system import CameraState, RayBatch, RayStats
from . import common

Tensor = torch.Tensor


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
    """Batched RAYTRACED ``camera_create_ray`` over flat ``[B]`` samples."""
    lens = state.lens
    if lens is None:
        raise ValueError("the raytraced model needs a compiled LensSystem")
    if sx.dim() != 1:
        raise ValueError(f"expected flat [B] samples, got {tuple(sx.shape)}")
    if seed is None:
        if generator is None:
            raise ValueError("create_rays needs a seed or a torch.Generator")
        # the JAX package draws it as jax.random.randint(key, (), 0, 1 << 22)
        seed = int(torch.randint(0, 1 << 22, (), generator=generator,
                                 device=generator.device))
    return _create_rays_kernel(state, config, sx, sy, lensx, lensy, seed)


def _create_rays_kernel(
    state: CameraState,
    config: CameraConfig,
    sx: Tensor,
    sy: Tensor,
    lensx: Tensor,
    lensy: Tensor,
    seed: int,
) -> Tuple[RayBatch, RayStats]:
    origin, direction, tries, tir = trace_kernel.raytraced_fused(
        state.lens, sx, sy, lensx, lensy, state.sensor_width, seed,
        max_tries=config.max_tries,
        use_lut=bool(config.kolb_sampling_lut),
        use_profile=bool(config.pupil_precheck
                         and state.lens.profile is not None),
    )
    weight, n_ok, n_vig = common.weight_and_stats(tries, config.max_tries)
    d_ody, d_ddy = common.fake_derivatives(tries, origin, direction)
    weight = common.apply_exposure(weight, state.exposure_control)
    stats = RayStats(
        n_ok, n_vig, tir.sum(dtype=torch.int32),
        tries.sum(dtype=torch.int32),
    )
    return RayBatch(origin, direction, weight, d_ody, d_ddy), stats
