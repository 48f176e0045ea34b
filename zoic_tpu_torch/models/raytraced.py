"""Raytraced ("Kolb") camera model: the fused-kernel path.

Counterpart of ``zoic_tpu/models/raytraced.py:_create_rays_pallas``.  The
whole sample -> shape -> trace -> retry pipeline runs in one kernel
(:mod:`zoic_tpu_torch.ops.trace_kernel`); with image bokeh the attempt-0
offsets and the retry planes are drawn first by
:func:`zoic_tpu_torch.bokeh.sample`.  The weight, exposure and derivative
epilogue stays in PyTorch.
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

# the retry planes' hash: seed offset and stream salts
# (zoic_tpu/models/raytraced.py:_create_rays_pallas)
PLANE_SEED_OFFSET = 0x5BD1
SALT_P1, SALT_P2 = 0x33333333, 0x44444444


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
    if config.use_image and state.bokeh is None:
        raise ValueError("use_image=True needs a state with a bokeh image")
    if seed is None:
        if generator is None:
            raise ValueError("create_rays needs a seed or a torch.Generator")
        # the JAX package draws it as jax.random.randint(key, (), 0, 1 << 22)
        seed = int(torch.randint(0, 1 << 22, (), generator=generator,
                                 device=generator.device))
    return _create_rays_kernel(state, config, sx, sy, lensx, lensy, seed)


def retry_planes(state: CameraState, max_tries: int, b: int,
                 seed: int) -> Tuple[Tensor, Tensor]:
    """``[P, Bp]`` bokeh offsets for the presampled retry draws: ``P =
    min(BOKEH_PLANES, max_tries + 1)`` planes of ``Bp = min(B, max(2**16,
    B // 8))`` draws, whose uniforms come from the counter hash keyed by
    the cell index and ``seed + 0x5BD1``."""
    n_planes = min(trace_kernel.BOKEH_PLANES, max_tries + 1)
    bp = min(b, max(1 << 16, b // 8))
    ids = torch.arange(n_planes * bp, dtype=torch.int64, device=state.device)
    zero = torch.zeros_like(ids)
    pseed = seed + PLANE_SEED_OFFSET
    pu1 = trace_kernel.hash_uniform(ids, pseed, zero, SALT_P1)
    pu2 = trace_kernel.hash_uniform(ids, pseed, zero, SALT_P2)
    ru1, ru2 = bokeh_mod.sample(state.bokeh, pu1, pu2)
    return ru1.reshape(n_planes, bp), ru2.reshape(n_planes, bp)


def kernel_inputs(state: CameraState, config: CameraConfig, lensx: Tensor,
                  lensy: Tensor, seed: int) -> Tuple[Tensor, Tensor, dict]:
    """The aperture inputs and keyword flags ``raytraced_fused`` takes for
    this camera: with image bokeh the attempt-0 offsets and the retry
    planes are drawn first; the pre-check runs when the config asks for
    it, the state has a profile and, with bokeh offsets (which fill the
    square), the profile was fitted over the square."""
    lens = state.lens
    presampled = bool(config.use_image)
    retry_u1 = retry_u2 = None
    if presampled:
        lensx, lensy = bokeh_mod.sample(state.bokeh, lensx, lensy)
        if config.max_tries > 0:
            retry_u1, retry_u2 = retry_planes(state, config.max_tries,
                                              lensx.shape[0], seed)
    flags = dict(
        max_tries=config.max_tries,
        use_lut=bool(config.kolb_sampling_lut),
        use_profile=bool(config.pupil_precheck and lens.profile is not None
                         and (not presampled
                              or lens.profile_domain == "square")),
        presampled=presampled, retry_u1=retry_u1, retry_u2=retry_u2,
    )
    return lensx, lensy, flags


def _create_rays_kernel(
    state: CameraState,
    config: CameraConfig,
    sx: Tensor,
    sy: Tensor,
    lensx: Tensor,
    lensy: Tensor,
    seed: int,
) -> Tuple[RayBatch, RayStats]:
    u1, u2, flags = kernel_inputs(state, config, lensx, lensy, seed)
    origin, direction, tries, tir = trace_kernel.raytraced_fused(
        state.lens, sx, sy, u1, u2, state.sensor_width, seed, **flags)
    weight, n_ok, n_vig = common.weight_and_stats(tries, config.max_tries)
    d_ody, d_ddy = common.fake_derivatives(tries, origin, direction)
    weight = common.apply_exposure(weight, state.exposure_control)
    stats = RayStats(
        n_ok, n_vig, tir.sum(dtype=torch.int32),
        tries.sum(dtype=torch.int32),
    )
    return RayBatch(origin, direction, weight, d_ody, d_ddy), stats
