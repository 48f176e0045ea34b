"""The lens solve: the raytraced model's ``node_update`` set-up pipeline.

Port of ``zoic_tpu/solve.py`` (reference: src/zoic.cpp:1615-1698):

* ``traceThroughLensElementsForFocalLength`` (zoic.cpp:1161-1228)
  -> :func:`trace_focal_length`;
* ``adjustFocalLength`` (zoic.cpp:1231-1237) -> :func:`rescale`;
* ``calculateImageDistance`` (zoic.cpp:1054-1095) -> :func:`image_distance`,
  with the JAX package's conditioning fix (the origin advanced along the ray
  to z ~ 1 before the trace);
* ``computeLensCenters`` (zoic.cpp:963-969) -> :func:`lens_centers`;
* the aperture-distance loop (zoic.cpp:1678-1685) -> :func:`aperture_distance`.

The JAX package runs the pipeline as one jitted float32 program; here it is
eager float32 on the camera's device, the element scan a Python loop, in the
same order of operations.
"""

from __future__ import annotations

import logging
from typing import NamedTuple, Tuple

import numpy as np
import torch

from . import lensfile, optics
from .config import CameraConfig
from .optics import V3, div, f32, v3
from .system import LensSystem
from .utils.profiling import readback

log = logging.getLogger("zoic")

Tensor = torch.Tensor


class Prescription(NamedTuple):
    """Element arrays prior to solving (rear-first, cm)."""

    curvature: Tensor
    thickness: Tensor
    ior: Tensor
    abbe: Tensor
    aperture: Tensor


def from_lensfile(rx: lensfile.LensPrescription, device="cuda") -> Prescription:
    def t(a):
        return optics.upload(np.asarray(a, np.float32), device)

    return Prescription(t(rx.curvature), t(rx.thickness), t(rx.ior),
                        t(rx.abbe), t(rx.aperture))


class FocalTrace(NamedTuple):
    focal_length: Tensor
    principal_plane: Tensor
    focal_point: Tensor


def _ior_next(p: Prescription) -> Tensor:
    return torch.cat([p.ior[1:], torch.ones(1, dtype=torch.float32,
                                            device=p.ior.device)])


def trace_focal_length(p: Prescription) -> FocalTrace:
    """Trace a near-axis parallel ray to find the (rear) principal plane and
    focal point (zoic.cpp:1161-1228).  The probe starts at height
    ``aperture[0] * 0.1`` with direction ``(0, 0, 99999)``; on TIR the
    direction is kept and the trace goes on."""
    dev = p.curvature.device
    e = p.curvature.shape[0]
    height = p.aperture[0] * f32(0.1)
    o = v3(0.0, height, 0.0, device=dev)
    d = v3(0.0, 0.0, 99999.0, device=dev)
    summed = optics.upload(0.0, dev)
    ior_next = _ior_next(p)
    o_last = d_last = None
    for i in range(e):
        curv = p.curvature[i]
        summed = summed + p.thickness[i]
        center_z = summed - curv
        hit, _ = optics.ray_sphere_intersect(
            o, d, center_z, curv, reverse=False, cull_miss=False
        )
        n = optics.sphere_normal(hit, center_z, curv)
        d_new, tir = optics.refract(d, n, p.ior[i], ior_next[i],
                                    check_tir=True)
        d = optics.where_v3(tir, d, d_new)
        # the reference computes the planes from the last element's entry
        # point, the origin before it moves to the final hit (zoic.cpp:1186)
        o_last, d_last = o, d
        o = hit
    pp_line2_end = V3(
        torch.zeros_like(o_last.y),
        o_last.y + d_last.y * 100000.0,
        o_last.z + d_last.z * 100000.0,
    )
    principal_plane, _ = optics.line_line_zy(
        v3(0.0, height, 0.0, device=dev), v3(0.0, height, 999999.0, device=dev),
        o_last, pp_line2_end,
    )
    focal_point = optics.line_plane_y0(o_last, d_last).z
    return FocalTrace(focal_point - principal_plane, principal_plane,
                      focal_point)


def rescale(p: Prescription, ratio: Tensor) -> Prescription:
    """``adjustFocalLength`` (zoic.cpp:1231-1237): scale ROC, thickness and
    aperture by the focal-length ratio (IOR and Abbe untouched)."""
    return Prescription(p.curvature * ratio, p.thickness * ratio, p.ior,
                        p.abbe, p.aperture * ratio)


def image_distance(p: Prescription, object_distance: Tensor) -> Tensor:
    """``calculateImageDistance`` (zoic.cpp:1054-1095): trace backwards from
    the in-focus object point through the stack (front to rear) and
    intersect y = 0 for the film-plane z of the requested focal distance."""
    dev = p.curvature.device
    e = p.curvature.shape[0]
    zero = optics.upload(0.0, dev)
    od = torch.as_tensor(object_distance, dtype=torch.float32)
    od = od.to(dev, non_blocking=od.device.type == "cpu")
    origin = V3(zero, zero, od)
    direction = V3(zero, div(p.aperture[e - 1], 2.0) * f32(0.05), -od)
    # conditioning fix of the JAX package (zoic_tpu/solve.py:150-158): the
    # trace starts at z ~ 1 on the same ray line, so positions stay O(1)
    d0 = optics.normalize(direction)
    t0 = torch.clamp_min((1.0 - origin.z) / d0.z, 0.0)
    origin = origin + d0.scale(t0)

    summed = _cumsum(p.thickness)[-1]
    o, d = origin, direction
    for i in range(e):
        # iteration i touches element E-1-i; the running thickness drops
        # thickness[E-i] for i >= 1 (zoic.cpp:1066)
        rev = e - 1 - i
        curv = p.curvature[rev]
        summed = summed - (zero if i == 0 else p.thickness[e - i])
        center_z = summed - curv
        hit, _ = optics.ray_sphere_intersect(
            o, d, center_z, curv, reverse=True, cull_miss=False
        )
        nrm = optics.sphere_normal(hit, center_z, -curv)
        n1 = torch.ones_like(zero) if i == 0 else p.ior[e - i]
        d, _ = optics.refract(d, nrm, n1, p.ior[rev], check_tir=False)
        o = hit
    return optics.line_plane_y0(o, d).z


def _cumsum(t: Tensor) -> Tensor:
    """Running float32 sum in element order, as the reference accumulates
    (and XLA sums a dozen elements); ``torch.cumsum`` on the CPU adds in
    float64 and ``torch.sum`` in lanes."""
    out = [t[0]]
    for v in t[1:]:
        out.append(out[-1] + v)
    return torch.stack(out)


def lens_centers(p: Prescription) -> Tensor:
    """``computeLensCenters`` (zoic.cpp:963-969): per-element sphere center
    z = cumulative thickness - curvature."""
    return _cumsum(p.thickness) - p.curvature


def aperture_distance(p: Prescription, aperture_element: int) -> Tensor:
    """Film-to-iris distance: cumulative thickness through the aperture
    element inclusive (zoic.cpp:1678-1685); 0 without an iris."""
    if aperture_element < 0:
        return torch.zeros((), dtype=torch.float32, device=p.thickness.device)
    return _cumsum(p.thickness[: aperture_element + 1])[-1]


def solve_lens(rx: lensfile.LensPrescription, config: CameraConfig,
               device="cuda") -> Tuple[LensSystem, dict]:
    """The raytraced set-up pipeline (zoic.cpp:1615-1698) but the exit-pupil
    LUT: returns the solved :class:`LensSystem` (``lut=None``) on ``device``
    and a dict of the derived quantities the reference logs."""
    p = from_lensfile(rx, device)
    ae = rx.aperture_element
    t1 = trace_focal_length(p)
    ratio = div(optics.upload(config.focal_length, device), t1.focal_length)
    p2 = rescale(p, ratio)
    t2 = trace_focal_length(p2)

    # 2 * f32(fstop) is exact: a power-of-two multiply
    user_ap = div(t2.focal_length, f32(2.0 * f32(config.fstop)))
    # clamp to the iris: the reference compares the radius against the
    # element's diameter value (zoic.cpp:1668-1671), a quirk kept; without
    # an iris row (aperture_element == -1) there is no clamp
    if ae >= 0:
        user_ap = torch.minimum(user_ap, p2.aperture[ae])

    origin_shift = image_distance(p2, f32(config.focal_distance))
    ap_dist = aperture_distance(p2, ae)
    centers = lens_centers(p2)
    sw, sh = (optics.upload(v, device)
              for v in (config.sensor_width, config.sensor_height))
    film_diag = optics.sqrt(sw * sw + sh * sh)

    system = LensSystem(
        curvature=p2.curvature,
        thickness=p2.thickness,
        ior=p2.ior,
        abbe=p2.abbe,
        aperture=p2.aperture,
        center=centers,
        user_aperture_radius=user_ap,
        origin_shift=origin_shift,
        aperture_distance=ap_dist,
        focal_length_ratio=ratio,
        traced_focal_length=t2.focal_length,
        film_diagonal=film_diag,
        focal_distance=optics.upload(config.focal_distance, device),
        lut=None,
        aperture_element=ae,
    )
    report = {
        "traced_focal_length_raw": t1.focal_length,
        "principal_plane_raw": t1.principal_plane,
        "focal_point_raw": t1.focal_point,
        "focal_length_ratio": ratio,
        "traced_focal_length": t2.focal_length,
        "principal_plane": t2.principal_plane,
        "focal_point": t2.focal_point,
        "user_aperture_radius": user_ap,
        "image_distance": origin_shift,
        "aperture_distance": ap_dist,
    }
    return system, report


_LABELS = {
    "principal_plane_raw": "[ZOIC] Principle Plane distance [cm]",
    "focal_point_raw": "[ZOIC] Focal point distance [cm]",
    "traced_focal_length_raw": "[ZOIC] Raytraced Focal Length [cm]",
    "focal_length_ratio": "[ZOIC] Focal length ratio",
    "principal_plane": "[ZOIC] Adj. PP distance [cm]",
    "focal_point": "[ZOIC] Adj. Focal point distance [cm]",
    "traced_focal_length": "[ZOIC] Adj. Raytraced Focal Length [cm]",
    "user_aperture_radius": "[ZOIC] User aperture radius [cm]",
    "image_distance": "[ZOIC] Image distance [cm]",
    "aperture_distance": "[ZOIC] Aperture distance [cm]",
}


def log_report(report: dict) -> None:
    """The derived quantities in the reference's aligned ``%-40s %12.8f``
    messages (zoic.cpp:1198-1224, 1091-1092, 1655-1682)."""
    if not log.isEnabledFor(logging.INFO):
        return
    keys = [k for k in _LABELS if k in report]
    values = readback(*(torch.as_tensor(report[k]) for k in keys))
    for key, value in zip(keys, values):
        log.info("%-40s %12.8f", _LABELS[key], float(value))
