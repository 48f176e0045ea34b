"""The floor of a thin-lens call's work: what every ray needs.

* Bytes: 16 B a ray in and 52 B out, each read or written once.
* FLOPs (each add and multiply one, an FMA two): the pinhole direction
  (the screen point 2, its |p|^2 4, the scale 3), the focal-plane point 3,
  the aperture point 2, the ray toward it 2 and its normalisation 8; with
  optical vignetting one vignetting test (7).  Retries count nothing.
"""

from __future__ import annotations

BYTES_IN = 16
BYTES_OUT = 52
PER_RAY = 24
VIGNETTING = 7


def floor(cam, lens_path, rays: int, lit: int):
    """``(flops, bytes)`` of calls of ``rays`` rays in all of the camera
    ``cam`` (its fields; there is no lens file and ``lit`` is not read)."""
    vignetting = cam.use_dof and cam.optical_vignetting_distance > 0.0
    flops = rays * (PER_RAY + (VIGNETTING if vignetting else 0))
    return flops, rays * (BYTES_IN + BYTES_OUT)
