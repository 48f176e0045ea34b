"""Batched element-stack tracing on tensors.

Port of ``zoic_tpu/trace.py``, the reference's tracer
``traceThroughLensElements`` (src/zoic.cpp:1099-1158): a rear-to-front loop
over the lens elements (sphere intersection, aperture and iris cull, Snell
refraction with TIR) applied to a whole batch at once.  The JAX package's
unrolled ``lax.scan`` is a Python loop over the at most a dozen elements.
A ray that dies keeps exactly the partial state the reference leaves:

* intersection miss / cull: origin frozen at the previous element's hit;
* TIR: origin advanced to the hit point, direction frozen.

The lens compile (:mod:`zoic_tpu_torch.pupil`) traces its LUT and pre-check
covers with :func:`trace_stack`; :func:`iris_c1_probe` decides the raytraced
kernel's iris refract-identity skip.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from . import optics
from .optics import V3
from .system import LensSystem

Tensor = torch.Tensor


class TraceResult(NamedTuple):
    origin: V3      # final (or frozen partial) hit point per ray
    direction: V3   # final (or frozen partial) direction per ray
    ok: Tensor      # bool — survived the full stack
    tir: Tensor     # bool — died by total internal reflection


def _ior_next(lens: LensSystem) -> Tensor:
    ones = torch.ones(1, dtype=torch.float32, device=lens.ior.device)
    return torch.cat([lens.ior[1:], ones])


def _cull(lens: LensSystem, i: int, hit: V3) -> Tensor:
    """Clear-aperture cull ``aperture[i]/2``, plus the user iris radius at
    the aperture element (zoic.cpp:1114-1117)."""
    hit2 = hit.x * hit.x + hit.y * hit.y
    half_ap = lens.aperture[i] * 0.5
    cull = hit2 > half_ap * half_ap
    if i == lens.aperture_element:
        ua = lens.user_aperture_radius
        cull = cull | (hit2 > ua * ua)
    return cull


def trace_stack(lens: LensSystem, origin: V3, direction: V3) -> TraceResult:
    """Trace a batch of rays rear-to-front through the element stack
    (``zoic_tpu.trace.trace_stack``).  Components may have any batch
    shape."""
    ior_next = _ior_next(lens)
    o, d = origin, direction
    active = torch.ones_like(origin.x, dtype=torch.bool)
    tir_any = torch.zeros_like(active)
    for i in range(lens.count):
        center_z, curv = lens.center[i], lens.curvature[i]
        hit, miss = optics.ray_sphere_intersect(
            o, d, center_z, curv, reverse=False, cull_miss=True
        )
        reached = active & ~miss & ~_cull(lens, i, hit)
        o = optics.where_v3(reached, hit, o)
        normal = optics.sphere_normal(hit, center_z, curv)
        d_new, tir = optics.refract(d, normal, lens.ior[i], ior_next[i],
                                    check_tir=True)
        tir = reached & tir
        active = reached & ~tir
        d = optics.where_v3(active, d_new, d)
        tir_any = tir_any | tir
    return TraceResult(o, d, active, tir_any)


def iris_c1_probe(lens: LensSystem, origin: V3,
                  direction: V3) -> Tuple[Tensor, Tensor]:
    """Cosine of incidence ``c1 = -(d . n)`` at the iris element per ray,
    and the mask of rays that reach it (``zoic_tpu.trace.iris_c1_probe``).
    The kernel's iris refract-identity skip is exact only when ``eta == 1``
    and ``c1 > 0`` for every reached-iris ray; ``compile_camera`` clears the
    skip when a probe ray has ``c1 <= 0`` (reference refract chain:
    zoic.cpp:1130-1144)."""
    ap_el = lens.aperture_element
    if ap_el < 0:
        raise ValueError("the iris probe needs an aperture element")
    ior_next = _ior_next(lens)
    o = origin
    d = optics.normalize(direction)
    active = torch.ones_like(o.x, dtype=torch.bool)
    for i in range(ap_el + 1):
        center_z, curv = lens.center[i], lens.curvature[i]
        hit, miss = optics.ray_sphere_intersect(
            o, d, center_z, curv, reverse=False, cull_miss=True
        )
        reached = active & ~miss & ~_cull(lens, i, hit)
        normal = optics.sphere_normal(hit, center_z, curv)
        if i == ap_el:
            return -optics.dot(d, optics.normalize(normal)), reached
        o = optics.where_v3(reached, hit, o)
        d_new, tir = optics.refract(d, normal, lens.ior[i], ior_next[i],
                                    check_tir=True)
        active = reached & ~tir
        d = optics.where_v3(active, d_new, d)
    raise AssertionError("unreachable")
