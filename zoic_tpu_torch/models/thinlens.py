"""Thin-lens camera model (``zoic_tpu/models/thinlens.py``).

The reference's THINLENS branch (src/zoic.cpp:1771-1848): pinhole
direction, optional depth of field, optional empirical optical vignetting
(a virtual second aperture at ``opticalVignettingDistance`` that rejects
rays missing a disk of ``apertureRadius * opticalVignettingRadius``,
zoic.cpp:1297-1305) with retry rounds, and image bokeh.  As in the
raytraced model, ``config.impl == "jnp"`` runs the exact eager path
(tensor ops, masked resample rounds from :func:`common.resample_rounds`);
anything else runs one kernel
(:func:`zoic_tpu_torch.ops.trace_kernel.thinlens_rays`) on the flattened
batch, with image bokeh after the aperture offsets are drawn by
:func:`zoic_tpu_torch.bokeh.sample`.  That kernel also computes the
weight, exposure, derivative and counter epilogue in its final store; the
eager path composes the epilogue's plain pieces (``models/common.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import bokeh as bokeh_mod
from .. import optics
from ..config import CameraConfig
from ..ops import trace_kernel
from ..optics import V3
from ..system import CameraState, RayBatch, RayStats
from ..utils.profiling import span
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
    """Batched THINLENS ``camera_create_ray``.

    Samples of any batch shape run the kernel unless ``config.impl ==
    "jnp"``: its retry hash is keyed by ``seed`` or by one drawn from
    ``generator``; with image bokeh and vignetting the retry planes are
    drawn from ``generator``, after the seed, or from a generator seeded
    with ``seed`` when only the seed is given.  The eager path draws its retry
    uniforms the same way."""
    if config.use_image and state.bokeh is None:
        raise ValueError("use_image=True needs a state with a bokeh image "
                         "(compile_camera loads it)")
    if config.impl == "jnp":
        return _create_rays_eager(
            state, config, sx, sy, lensx, lensy,
            common.retry_generator(seed, generator, sx.device))
    if seed is None:
        if generator is None:
            raise ValueError("create_rays needs a seed or a torch.Generator")
        # the JAX package draws it as jax.random.randint(key, (), 0, 1 << 22)
        seed = int(torch.randint(0, 1 << 22, (), generator=generator,
                                 device=generator.device))
    if sx.dim() == 1:
        return _create_rays_kernel(state, config, sx, sy, lensx, lensy, seed,
                                   generator)
    rays, stats = _create_rays_kernel(
        state, config, *(a.reshape(-1) for a in (sx, sy, lensx, lensy)), seed,
        generator)
    return common.unflatten(rays, sx.shape), stats


def _vignette_pass(ox: Tensor, oy: Tensor, dx: Tensor, dy: Tensor,
                   aperture_radius: Tensor, ov_radius: Tensor,
                   ov_distance: Tensor) -> Tensor:
    """``empericalOpticalVignetting`` (zoic.cpp:1297-1305).  The reference
    computes ``dir * distance - origin``, not ``origin + dir * t``; kept, it
    is the shape of the effect users tuned against."""
    px = dx * ov_distance - ox
    py = dy * ov_distance - oy
    hyp = optics.sqrt(px * px + py * py)
    return torch.abs(hyp) < aperture_radius * ov_radius


def _dof_attempt(state: CameraState, config: CameraConfig, pd: V3,
                 u1: Tensor, u2: Tensor) -> Tuple[Tensor, tuple]:
    """One depth-of-field attempt from uniforms ``(u1, u2)``: the aperture
    sample, the origin on the lens, the refocus through the focal plane
    along the pinhole direction ``pd`` (zoic.cpp:1786-1820).  Returns
    ``(ok, (ox, oy, dx, dy, dz))``."""
    lx, ly = common.aperture_sample(config.use_image, state.bokeh, u1, u2)
    lx = lx * state.aperture_radius
    ly = ly * state.aperture_radius
    # focal-plane intersection along the pinhole ray (zoic.cpp:1798-1800)
    t = torch.abs(state.focal_distance / pd.z)
    d = optics.normalize(V3(pd.x * t - lx, pd.y * t - ly, pd.z * t))
    if config.optical_vignetting_distance > 0.0:
        ok = _vignette_pass(lx, ly, d.x, d.y, state.aperture_radius,
                            state.ov_radius, state.ov_distance)
    else:
        ok = torch.ones_like(lx, dtype=torch.bool)
    return ok, (lx, ly, d.x, d.y, d.z)


def _create_rays_eager(
    state: CameraState,
    config: CameraConfig,
    sx: Tensor,
    sy: Tensor,
    lensx: Tensor,
    lensy: Tensor,
    generator: torch.Generator,
) -> Tuple[RayBatch, RayStats]:
    # pinhole direction (zoic.cpp:1774-1777) from the camera origin
    pd = optics.normalize(V3(sx * state.tan_fov, sy * state.tan_fov,
                             torch.ones_like(sx)))
    zero = torch.zeros((), dtype=torch.int32, device=sx.device)
    tries = torch.zeros(sx.shape, dtype=torch.int32, device=sx.device)
    if not config.use_dof:
        origin = torch.zeros(sx.shape + (3,), dtype=torch.float32,
                             device=sx.device)
        direction = torch.stack([pd.x, pd.y, pd.z * -1.0], dim=-1)
        weight = common.apply_exposure(torch.ones_like(sx),
                                       state.exposure_control)
        d_ody, d_ddy = common.fake_derivatives(tries, origin, direction)
        stats = RayStats(zero, zero, zero, zero)
        return RayBatch(origin, direction, weight, d_ody, d_ddy), stats

    ok0, payload = _dof_attempt(state, config, pd, lensx, lensy)
    tir_total = zero
    if config.optical_vignetting_distance > 0.0:

        def retry(u: Tensor, pending: Tensor):
            ok, payload = _dof_attempt(state, config, pd, u[0], u[1])
            return ok, payload, zero

        _, payload, tries, tir_total = common.resample_rounds(
            ok0, payload, retry, generator, config.max_tries, zero)
    lx, ly, dx, dy, dz = payload
    weight, n_ok, n_vig = common.weight_and_stats(tries, config.max_tries)
    origin = torch.stack([lx, ly, torch.zeros_like(lx)], dim=-1)
    # looking down -Z (zoic.cpp:1845)
    direction = torch.stack([dx, dy, dz * -1.0], dim=-1)
    d_ody, d_ddy = common.fake_derivatives(tries, origin, direction)
    weight = common.apply_exposure(weight, state.exposure_control)
    stats = RayStats(n_ok, n_vig, tir_total, tries.sum(dtype=torch.int32))
    return RayBatch(origin, direction, weight, d_ody, d_ddy), stats


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
    with span("zoic.kernel_inputs"):
        if presampled:
            # attempt 0's bokeh-CDF draw per ray; with vignetting the retry
            # rounds read presampled planes (zoic.cpp:1815 in-loop redraws)
            lensx, lensy = bokeh_mod.sample(state.bokeh, lensx, lensy)
            if has_ov and config.max_tries > 0 and config.use_dof:
                with span("zoic.thinlens.retry_planes"):
                    if generator is None:
                        generator = torch.Generator(
                            device=sx.device).manual_seed(seed)
                    retry_u1, retry_u2 = retry_planes(
                        state, config, sx.shape[0], generator)
    # the pinhole keeps weight 1 and counts no successes
    *rays, stats = trace_kernel.thinlens_rays(
        sx, sy, lensx, lensy,
        state.tan_fov, state.aperture_radius, state.focal_distance,
        state.ov_distance, state.ov_radius, seed, state.exposure_control,
        use_dof=config.use_dof,
        has_ov=has_ov,
        max_tries=config.max_tries,
        presampled=presampled,
        retry_u1=retry_u1,
        retry_u2=retry_u2,
    )
    return RayBatch(*rays), common.ray_stats(stats)
