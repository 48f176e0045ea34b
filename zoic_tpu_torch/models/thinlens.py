"""Thin-lens camera model: the fused-kernel path.

Counterpart of ``zoic_tpu/models/thinlens.py:_create_rays_pallas``
(the reference's THINLENS branch, src/zoic.cpp:1771-1848): pinhole
direction, optional depth of field, optional empirical optical vignetting
with retry rounds, and image bokeh.  The per-ray work runs in one kernel
(:func:`zoic_tpu_torch.ops.trace_kernel.thinlens_fused`); with image bokeh
the aperture offsets are drawn first by :func:`zoic_tpu_torch.bokeh.sample`.
The weight, exposure and derivative epilogue is ``models/common.py``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import bokeh as bokeh_mod
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
    """Batched THINLENS ``camera_create_ray`` over flat ``[B]`` samples.

    The retry hash is keyed by ``seed`` or by one drawn from ``generator``.
    With image bokeh and vignetting the retry planes are drawn from
    ``generator``, after the seed, or from a generator seeded with
    ``seed`` when only the seed is given."""
    if sx.dim() != 1:
        raise ValueError(f"expected flat [B] samples, got {tuple(sx.shape)}")
    if config.use_image and state.bokeh is None:
        raise ValueError("use_image=True needs a state with a bokeh image "
                         "(compile_camera loads it)")
    if seed is None:
        if generator is None:
            raise ValueError("create_rays needs a seed or a torch.Generator")
        # the JAX package draws it as jax.random.randint(key, (), 0, 1 << 22)
        seed = int(torch.randint(0, 1 << 22, (), generator=generator,
                                 device=generator.device))
    return _create_rays_kernel(state, config, sx, sy, lensx, lensy, seed,
                               generator)


def retry_planes(state, config, b, generator):
    """``n_planes`` planes of ``bp`` bokeh offsets for the retry rounds:
    quarter-batch planes that grid tiles share (``_create_rays_pallas``)."""
    n_planes = min(trace_kernel.BOKEH_PLANES, config.max_tries + 1)
    bp = min(b, max(1 << 16, b // 4))
    u = torch.rand((2, n_planes * bp), generator=generator,
                   device=generator.device, dtype=torch.float32)
    u = u.to(state.device)
    ru1, ru2 = bokeh_mod.sample(state.bokeh, u[0], u[1])
    return ru1.reshape(n_planes, bp), ru2.reshape(n_planes, bp)


def _create_rays_kernel(
    state: CameraState,
    config: CameraConfig,
    sx: Tensor,
    sy: Tensor,
    lensx: Tensor,
    lensy: Tensor,
    seed: int,
    generator: Optional[torch.Generator],
) -> Tuple[RayBatch, RayStats]:
    presampled = bool(config.use_image)
    has_ov = config.optical_vignetting_distance > 0.0
    retry_u1 = retry_u2 = None
    if presampled:
        # attempt 0's bokeh-CDF draw per ray; with vignetting the retry
        # rounds read presampled planes (zoic.cpp:1815 in-loop redraws)
        lensx, lensy = bokeh_mod.sample(state.bokeh, lensx, lensy)
        if has_ov and config.max_tries > 0 and config.use_dof:
            if generator is None:
                generator = torch.Generator(device=sx.device).manual_seed(seed)
            retry_u1, retry_u2 = retry_planes(state, config, sx.shape[0],
                                              generator)
    origin, direction, tries = trace_kernel.thinlens_fused(
        sx, sy, lensx, lensy,
        state.tan_fov, state.aperture_radius, state.focal_distance,
        state.ov_distance, state.ov_radius, seed,
        use_dof=config.use_dof,
        has_ov=has_ov,
        max_tries=config.max_tries,
        presampled=presampled,
        retry_u1=retry_u1,
        retry_u2=retry_u2,
    )
    zero = torch.zeros((), dtype=torch.int32, device=sx.device)
    if config.use_dof:
        weight, n_ok, n_vig = common.weight_and_stats(tries, config.max_tries)
    else:
        weight, n_ok, n_vig = torch.ones_like(sx), zero, zero
    d_ody, d_ddy = common.fake_derivatives(tries, origin, direction)
    weight = common.apply_exposure(weight, state.exposure_control)
    stats = RayStats(n_ok, n_vig, zero, tries.sum(dtype=torch.int32))
    return RayBatch(origin, direction, weight, d_ody, d_ddy), stats
