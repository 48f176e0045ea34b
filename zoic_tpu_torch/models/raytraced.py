"""Raytraced ("Kolb") camera model (``zoic_tpu/models/raytraced.py``).

Two paths: ``config.impl == "jnp"`` runs the exact eager path, anything
else the fused kernel, on any batch shape (a batch that is not flat is
flattened for the kernel and its rays given back in the caller's shape;
the JAX package sends such a batch to its eager path only because its
Pallas kernel takes flat blocks).

* The kernel path (``_create_rays_pallas``): the whole sample -> shape ->
  trace -> retry pipeline runs in one kernel
  (:mod:`zoic_tpu_torch.ops.trace_kernel`); with image bokeh the attempt-0
  offsets are drawn first by :func:`zoic_tpu_torch.bokeh.sample` and the
  retry planes by :func:`zoic_tpu_torch.ops.bokeh_kernel.planes_fused`, one
  launch that hashes each plane cell and inverts the CDF.
* The eager path (the reference's RAYTRACED branch of
  ``camera_create_ray``, src/zoic.cpp:1850-1964, as tensor ops): film
  point at ``(sx, sy) * sensorWidth / 2``, aperture sample targeted at the
  first element naively or shaped by the exit-pupil LUT, the full element
  trace (:func:`zoic_tpu_torch.trace.trace_stack`), masked resample rounds
  (:func:`common.resample_rounds`) and the final sign flip.  It traces every
  attempt (no pre-check), is differentiable, and is the kernels' readable
  reference.  In the LUT retry path the centroid translation moves x only,
  as on the first attempt (the JAX package's reading of zoic.cpp:1933).

On the kernel path the raytraced kernel also writes the weight, exposure,
derivatives and counters where each ray finishes
(:func:`zoic_tpu_torch.ops.trace_kernel.raytraced_rays`: one launch, no
epilogue pass); the eager path composes the epilogue's plain pieces
(``models/common.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import bokeh as bokeh_mod
from .. import pupil, trace
from ..config import CameraConfig
from ..ops import bokeh_kernel, trace_kernel
from ..optics import V3
from ..system import CameraState, RayBatch, RayStats
from ..utils.profiling import span
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
    """Batched RAYTRACED ``camera_create_ray``.

    Samples of any batch shape run the kernel unless ``config.impl ==
    "jnp"``; the eager path draws its retry uniforms from ``generator``, or
    from a generator seeded with ``seed``."""
    lens = state.lens
    if lens is None:
        raise ValueError("the raytraced model needs a compiled LensSystem")
    if config.use_image and state.bokeh is None:
        raise ValueError("use_image=True needs a state with a bokeh image")
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
        return _create_rays_kernel(state, config, sx, sy, lensx, lensy, seed)
    rays, stats = _create_rays_kernel(
        state, config, *(a.reshape(-1) for a in (sx, sy, lensx, lensy)), seed)
    return common.unflatten(rays, sx.shape), stats


def _attempt(state: CameraState, config: CameraConfig, film: V3, shaping,
             u1: Tensor, u2: Tensor) -> Tuple[Tensor, tuple, Tensor]:
    """One trace attempt from aperture uniforms ``(u1, u2)``
    (``zoic_tpu/models/raytraced.py:_attempt``).  Returns ``(ok, (ox, oy,
    oz, dx, dy, dz), tir)`` with a failed ray's partial state frozen as the
    reference leaves it."""
    lens = state.lens
    lx, ly = common.aperture_sample(config.use_image, state.bokeh, u1, u2)
    if shaping is None:
        # naive: the lens-UV scaled by the first element's diameter
        # (zoic.cpp:1874-1875), a 2x over-cover the reference has
        tx = lx * lens.aperture[0]
        ty = ly * lens.aperture[0]
    else:
        max_scale, translation, sin_t, cos_t = shaping
        sx_ = lx * max_scale + translation
        sy_ = ly * max_scale
        tx = sx_ * cos_t - sy_ * sin_t
        ty = sx_ * sin_t + sy_ * cos_t
    dz = torch.zeros_like(film.x) - lens.thickness[0]
    res = trace.trace_stack(lens, film, V3(tx - film.x, ty - film.y, dz))
    return res.ok, (*res.origin, *res.direction), res.tir


def _create_rays_eager(
    state: CameraState,
    config: CameraConfig,
    sx: Tensor,
    sy: Tensor,
    lensx: Tensor,
    lensy: Tensor,
    generator: torch.Generator,
) -> Tuple[RayBatch, RayStats]:
    lens = state.lens
    half = state.sensor_width * 0.5
    # width for both axes (zoic.cpp:1853-1854)
    film = V3(sx * half, sy * half, torch.zeros_like(sx) + lens.origin_shift)
    shaping = None
    if config.kolb_sampling_lut:
        if lens.lut is None:
            raise ValueError("kolb_sampling_lut=True needs a built LUT")
        # once per ray, reused by every retry (zoic.cpp:1891-1911)
        shaping = pupil.lut_shaping(lens.lut, film.x, film.y)
    ok0, payload0, tir0 = _attempt(state, config, film, shaping, lensx, lensy)

    def retry(u: Tensor, pending: Tensor):
        ok, payload, tir = _attempt(state, config, film, shaping, u[0], u[1])
        # TIR counted on the rays that retried this round only
        return ok, payload, (tir & pending).sum(dtype=torch.int32)

    _, payload, tries, tir_total = common.resample_rounds(
        ok0, payload0, retry, generator, config.max_tries,
        tir0.sum(dtype=torch.int32))
    pox, poy, poz, pdx, pdy, pdz = payload
    weight, n_ok, n_vig = common.weight_and_stats(tries, config.max_tries)
    # flip direction and origin (zoic.cpp:1960-1961)
    origin = torch.stack([-pox, -poy, -poz], dim=-1)
    direction = torch.stack([-pdx, -pdy, -pdz], dim=-1)
    d_ody, d_ddy = common.fake_derivatives(tries, origin, direction)
    weight = common.apply_exposure(weight, state.exposure_control)
    stats = RayStats(n_ok, n_vig, tir_total, tries.sum(dtype=torch.int32))
    return RayBatch(origin, direction, weight, d_ody, d_ddy), stats


def plane_shape(max_tries: int, b: int) -> Tuple[int, int]:
    """``(P, Bp)`` of the retry planes for ``b`` rays: ``P =
    min(BOKEH_PLANES, max_tries + 1)`` planes of ``Bp = min(B, max(2**16,
    B // 8))`` draws."""
    return (min(trace_kernel.BOKEH_PLANES, max_tries + 1),
            min(b, max(1 << 16, b // 8)))


def retry_planes(state: CameraState, max_tries: int, b: int,
                 seed: int) -> Tuple[Tensor, Tensor]:
    """``[P, Bp]`` bokeh offsets for the presampled retry draws
    (:func:`plane_shape`), whose uniforms come from the counter hash keyed
    by the cell index and ``seed + 0x5BD1``: one launch of the plane entry
    for a state on the card, the plain version on the CPU."""
    n_planes, bp = plane_shape(max_tries, b)
    ru1, ru2 = bokeh_kernel.planes_fused(
        state.bokeh, n_planes * bp, seed + PLANE_SEED_OFFSET, SALT_P1,
        SALT_P2)
    return ru1.reshape(n_planes, bp), ru2.reshape(n_planes, bp)


def kernel_inputs(state: CameraState, config: CameraConfig, lensx: Tensor,
                  lensy: Tensor, seed: int) -> Tuple[Tensor, Tensor, dict]:
    """The aperture inputs and keyword flags ``raytraced_rays`` takes for
    this camera: with image bokeh the attempt-0 offsets and the retry
    planes are drawn first; the pre-check runs when the config asks for
    it, the state has a profile and, with bokeh offsets (which fill the
    square), the profile was fitted over the square."""
    with span("zoic.kernel_inputs"):
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
            use_profile=bool(config.pupil_precheck
                             and lens.profile is not None
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
    *rays, stats = trace_kernel.raytraced_rays(
        state.lens, sx, sy, u1, u2, state.sensor_width, seed,
        state.exposure_control, **flags)
    return RayBatch(*rays), common.ray_stats(stats)
