"""The floor of the raytraced kernel's own work (``csrc/raytraced.cu``),
apart from the epilogue and the rest of a call: what any kernel that
traces a call's rays has to do, so that a share of it cannot pass 100%.

* Bytes: each input read once and each output written once, 16 B a ray in
  (``sx``, ``sy`` and the two lens samples) and 32 B out (``origin``,
  ``dir``, ``tries``, ``tir``).
* FLOPs: one full trace for each lit ray, as ``counts/raytraced.py``
  counts it; retried and rejected attempts count nothing.
"""

from __future__ import annotations

from benchmark.core import cells

_CALL = cells.module("counts", "raytraced")

BYTES_IN = _CALL.BYTES_IN
BYTES_OUT = 12 + 12 + 4 + 4


def floor(cam, lens_path: str, rays: int, lit: int):
    """``(flops, bytes)`` of the kernel over ``rays`` rays in all, ``lit``
    of them lit, through the lens file at ``lens_path`` (``cam`` is not
    read)."""
    n, n_iris = _CALL.surfaces(lens_path)
    return (lit * _CALL.flops_per_ray(n, n_iris),
            rays * (BYTES_IN + BYTES_OUT))
