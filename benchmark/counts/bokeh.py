"""The floors of the two bokeh kernels of a raytraced call with image bokeh
(``csrc/bokeh.cu``), each apart from the rest of the call: what any
kernel that does its work has to move, so that a share of it cannot pass
100%.  Neither does a FLOP: a CDF search compares and selects.

* The sampler (the attempt-0 offsets): 8 B in (two uniforms) and 8 B out
  (``dx``, ``dy``) a draw, one draw a ray, and the image's tables read
  once a call.
* The retry planes: 8 B out (``dx``, ``dy``) a cell over ``P * Bp``
  cells a call, ``P = min(4, max_tries + 1)`` and ``Bp = min(B, max(2**16,
  B // 8))`` as the reference computes them (``reference/rays.py``,
  ``create_rays``), and the tables once a call; the cell's uniforms are
  hashed from its index, so nothing is read a cell.

The tables of an ``h x w`` image are its row CDF and row offsets and, for
each row, its column CDF and column offsets with one pad entry: ``2h(w +
2)`` floats, ``8 h (w + 2)`` bytes.  The benchmark's image is the
``bokeh_disk`` x ``bokeh_disk`` disk of ``core/inputs.bokeh_disk``.
"""

from __future__ import annotations

from typing import Iterable, Tuple

from benchmark.reference.rays import BOKEH_PLANES

BYTES_PER_DRAW = 8 + 8
BYTES_PER_CELL = 8


def tables_bytes(h: int, w: int) -> int:
    """Bytes of the tables a search of an ``h x w`` image reads."""
    return 8 * h * (w + 2)


def plane_cells(max_tries: int, b: int) -> int:
    """Cells of the retry planes of a call of ``b`` rays: ``P * Bp``, or 0
    where the camera takes no retries."""
    if max_tries <= 0:
        return 0
    return min(BOKEH_PLANES, max_tries + 1) * min(b, max(1 << 16, b // 8))


def _image(cam) -> Tuple[int, int]:
    n = int(cam.bokeh_disk)
    return n, n


def sampler_floor(cam, sizes: Iterable[int]) -> Tuple[int, int]:
    """``(flops, bytes)`` of the sampler over calls of ``sizes`` rays,
    through the camera ``cam`` (its fields)."""
    tables = tables_bytes(*_image(cam))
    return 0, sum(b * BYTES_PER_DRAW + tables for b in sizes if b > 0)


def planes_floor(cam, sizes: Iterable[int]) -> Tuple[int, int]:
    """``(flops, bytes)`` of the plane entry over calls of ``sizes`` rays,
    through the camera ``cam`` (its fields)."""
    tables = tables_bytes(*_image(cam))
    cells = [plane_cells(cam.max_tries, b) for b in sizes]
    return 0, sum(c * BYTES_PER_CELL + tables for c in cells if c > 0)
