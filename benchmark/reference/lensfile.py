"""Frozen copy of the port's lens-file parser (``zoic_tpu_torch/lensfile.py``), for
the benchmark's plain reference: it imports nothing of the port, so a
later change to the port cannot move the yardstick.  The original
docstring follows.

Tabular lens-prescription parsing and normalization.

A copy of ``zoic_tpu/lensfile.py``, which needs numpy alone but cannot be
imported from ``zoic_tpu`` without importing jax (``zoic_tpu/__init__.py``).
Parsing and cleanup are the same, so both packages read a ``.dat`` file into
equal float32 arrays.

Port of the reference's lens data pipeline (reference: src/zoic.cpp:708-959):

* ``readTabularLensData`` (zoic.cpp:708-914) — parses 4- or 5-column tabular
  ``.dat`` files (ROC / thickness / IOR / [Abbe V] / aperture), autodetecting
  the column count, skipping ``#`` comments, splitting on any of
  ``\\t,;: ``, and **reversing** the element order so index 0 is the
  rear-most element (closest to the film, zoic.cpp:913).
* ``cleanupLensData`` (zoic.cpp:917-959) — locates the aperture element
  (ROC == 0), flattens its ROC to 99999.0, rejects multiple apertures,
  converts IOR 0 -> 1.0 (air), scales mm -> cm (x0.1), and shifts the stack
  so the rear element sits at the origin (element 0's thickness becomes
  negative by the total stack thickness).

The result is a struct-of-arrays :class:`LensPrescription` of NumPy float32
arrays; parsing runs on the host, everything downstream is PyTorch.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import List

import numpy as np

log = logging.getLogger("zoic")

# Delimiters accepted by the reference parser (zoic.cpp:728).
_DELIMS = "\t,;: "

# The reference flattens the aperture's ROC to this value so the same
# ray-sphere intersection code handles it (zoic.cpp:931-933).  Note this
# happens BEFORE the mm->cm scale, so the effective ROC is 9999.9 cm.
APERTURE_FLAT_ROC = 99999.0


class LensFileError(ValueError):
    """Raised for the conditions where the reference aborts the render
    (zoic.cpp:745-754 column count, zoic.cpp:926-929 multiple apertures)."""


@dataclasses.dataclass(frozen=True)
class LensPrescription:
    """SoA lens element stack, rear element first.

    All arrays are float32 with shape ``[E]``.  ``aperture`` stores the
    element's clear-aperture *diameter* (the trace culls at ``aperture/2``,
    zoic.cpp:1114).  ``aperture_element`` is the index of the iris.  Units
    are centimeters after :func:`cleanup` (mm in the raw file).
    """

    curvature: np.ndarray   # radius of curvature; sign = orientation
    thickness: np.ndarray   # axial distance to next surface
    ior: np.ndarray         # index of refraction of the medium behind surface
    abbe: np.ndarray        # Abbe V-number (0 when absent; 4-column files)
    aperture: np.ndarray    # clear-aperture diameter
    aperture_element: int = -1

    @property
    def count(self) -> int:
        return int(self.curvature.shape[0])

    def rows(self) -> List[tuple]:
        return list(
            zip(self.curvature, self.thickness, self.ior, self.abbe, self.aperture)
        )


def _tokenize(line: str) -> List[str]:
    """Split a data line on the reference delimiter set, dropping empties
    (mirrors the find_first_of loop at zoic.cpp:728-733)."""
    out, cur = [], []
    for ch in line:
        if ch in _DELIMS:
            if cur:
                out.append("".join(cur))
                cur = []
        else:
            cur.append(ch)
    if cur:
        out.append("".join(cur))
    return out


def parse(path: str) -> LensPrescription:
    """Parse a tabular ``.dat`` lens file (raw: mm, front element first in
    file; returned rear-first per zoic.cpp:913)."""
    try:
        with open(path, "r") as f:
            text = f.read()
    except OSError as e:
        # the reference aborts the render on a missing/unreadable path
        # (zoic.cpp:1639-1641); our abort class is LensFileError(ValueError)
        raise LensFileError(f"cannot read lens data file {path!r}: {e}") from e
    return parse_text(text)


def parse_text(text: str) -> LensPrescription:
    data_rows: List[List[float]] = []
    total_tokens = 0
    n_lines = 0
    n_comments = 0
    for raw in text.splitlines():
        if not raw or raw[0] == "#":
            n_comments += 1
            continue
        toks = _tokenize(raw)
        if not toks:
            n_comments += 1
            continue
        total_tokens += len(toks)
        n_lines += 1
        data_rows.append([float(t) for t in toks])

    if n_lines == 0:
        raise LensFileError("lens data file contains no data rows")

    # Column-count autodetect: the reference averages tokens-per-line over the
    # whole file and truncates (zoic.cpp:741).
    columns = int(total_tokens / n_lines)
    log.info("%-40s %12d", "[ZOIC] Data file columns", columns)
    if columns < 4:
        raise LensFileError(
            "Failed to read lens data file: fewer than 4 columns of data found."
        )
    if columns > 5:
        raise LensFileError(
            "Failed to read lens data file: more than 5 columns of data found."
        )

    curvature, thickness, ior, abbe, aperture = [], [], [], [], []
    # The reference's tokenizer carries ``lensDataCounter`` across lines, so a
    # row's fields may technically span lines; all shipped lens files are
    # one-row-per-element, and we require that here (stricter than reference).
    for row in data_rows:
        if len(row) != columns:
            raise LensFileError(
                f"lens data row has {len(row)} fields, expected {columns}"
            )
        if columns == 4:
            c, t, n, a = row
            v = 0.0
        else:
            c, t, n, v, a = row
        curvature.append(c)
        thickness.append(t)
        ior.append(n)
        abbe.append(v)
        aperture.append(a)

    # Rear-most element first (zoic.cpp:913).
    rx = LensPrescription(
        curvature=np.asarray(curvature[::-1], np.float32),
        thickness=np.asarray(thickness[::-1], np.float32),
        ior=np.asarray(ior[::-1], np.float32),
        abbe=np.asarray(abbe[::-1], np.float32),
        aperture=np.asarray(aperture[::-1], np.float32),
    )
    log.info("%-40s %12d", "[ZOIC] Comment lines ignored", n_comments)
    for i in range(rx.count):
        log.info(
            "[ZOIC] %10.4f  %10.4f  %10.4f  %10.4f",
            rx.curvature[i], rx.thickness[i], rx.ior[i], rx.aperture[i],
        )
    return rx


def cleanup(rx: LensPrescription) -> LensPrescription:
    """Normalize a parsed prescription (reference ``cleanupLensData``,
    zoic.cpp:917-959): find/flatten the aperture, fix air IOR, mm -> cm,
    shift so the rear element is at the origin."""
    curvature = rx.curvature.astype(np.float32).copy()
    thickness = rx.thickness.astype(np.float32).copy()
    ior = rx.ior.astype(np.float32).copy()

    aperture_indices = np.nonzero(curvature == 0.0)[0]
    if aperture_indices.size > 1:
        raise LensFileError(
            "Multiple apertures found. Provide lens description with 1 aperture."
        )
    aperture_element = int(aperture_indices[0]) if aperture_indices.size else -1
    if aperture_element >= 0:
        log.info(
            "[ZOIC] Adjusted ROC[%d] [%.4f] to [99999.0]", aperture_element, 0.0
        )
        curvature[aperture_element] = APERTURE_FLAT_ROC

    for i in np.nonzero(ior == 0.0)[0]:
        log.info("[ZOIC] Changed IOR[%d] [%.4f] to [1.0000]", i, 0.0)
    ior[ior == 0.0] = 1.0

    # mm -> cm, float32 multiply to match reference arithmetic (zoic.cpp:946-950)
    scale = np.float32(0.1)
    curvature *= scale
    thickness *= scale
    aperture = rx.aperture.astype(np.float32) * scale

    # Shift the stack so the rear element sits at the origin: subtract the
    # total thickness from element 0 (zoic.cpp:952-958).  The reference
    # accumulates the sum in float32; match that order and precision.
    summed = np.float32(0.0)
    for t in thickness:
        summed = np.float32(summed + t)
    thickness[0] = np.float32(thickness[0] - summed)

    log.info("%-40s %12d", "[ZOIC] Aperture is lens element number", aperture_element)
    return LensPrescription(
        curvature=curvature,
        thickness=thickness,
        ior=ior,
        abbe=rx.abbe.astype(np.float32),
        aperture=aperture,
        aperture_element=aperture_element,
    )


def load(path: str) -> LensPrescription:
    """Parse + cleanup, the full host-side ingestion path."""
    return cleanup(parse(path))
