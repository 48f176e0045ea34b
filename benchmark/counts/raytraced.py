"""The floor of a raytraced call's work: what any implementation has to
do, whatever kernels do it, so that a share of it cannot pass 100%.

* Bytes: each input read once and each output written once, 16 B a ray in
  (``sx``, ``sy``, ``lensx``, ``lensy``) and 52 B out (``origin``,
  ``dir``, ``d_ody``, ``d_ddy``, ``weight``).
* FLOPs: one full trace through the prescription's surfaces for each ray
  whose output weight is not zero, counted from the call's own outputs;
  retried and rejected attempts count nothing (an implementation may skip
  them).  Each add and each multiply is one FLOP (an FMA two); square
  roots, divisions, compares and selects count nothing.  The iris, where
  the index does not change, is intersected and culled but not refracted.
"""

from __future__ import annotations

BYTES_IN = 16
BYTES_OUT = 52
# |d|^2 (3 mul, 2 add) and the scale by its inverse root (3 mul)
NORMALIZE = 8
# the sphere hit: lz 1, tca 5, closest point 6, d2 5, r^2 - d2 1, t 1,
# the hit's x, y 4, its radius^2 3, its z 2
INTERSECT = 28
# the refraction: wz 1, c1 6, cs2 3, k 3, k / R 1, the new direction 9
REFRACT = 23


def flops_per_ray(n_surfaces: int, n_iris: int) -> int:
    """FLOPs of one full trace through ``n_surfaces`` surfaces, ``n_iris``
    of them an iris."""
    return NORMALIZE + n_surfaces * INTERSECT + (n_surfaces - n_iris) * REFRACT


def surfaces(lens_path: str):
    """Surfaces and irises (rows of radius 0) of a tabular lens file."""
    rows = []
    with open(lens_path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                rows.append(float(line.replace(",", " ").split()[0]))
    return len(rows), sum(1 for r in rows if r == 0.0)


def floor(cam, lens_path: str, rays: int, lit: int):
    """``(flops, bytes)`` of calls of ``rays`` rays in all, ``lit`` of
    them with a weight that is not zero, through the lens file at
    ``lens_path`` (``cam``, the camera's fields, is not read)."""
    n, n_iris = surfaces(lens_path)
    return lit * flops_per_ray(n, n_iris), rays * (BYTES_IN + BYTES_OUT)
