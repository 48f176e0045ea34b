"""``draw.zoic``-compatible dump writer and parser.

The port's own copy of ``zoic_tpu/diag/dump.py`` (importing anything under
``zoic_tpu`` imports jax).  Reference: ``writeToFile`` (src/zoic.cpp:
1240-1293) emits the lens geometry header and the per-ray 2D (z, y)
segments appended by the trace loop (zoic.cpp:1121-1153, 1833-1841);
``draw.py`` consumes the format.  Keeping the format means the reference's
own checked-in dump (src/draw.zoic) and any dump the C++ plugin or the JAX
package writes can be read and drawn here, and the port's by theirs.

Conventions (from the reference writer): geometry z-values are negated
(``-center``, ``-curvature``, ``-apertureDistance``, ``-originShift``,
``-focalDistance``); LENSES holds per-element triples
(-center, -curvature, arc half-angle in degrees = asin(ap/2 / curvature));
RAYS is a flat list of (z1 y1 z2 y2) segments.  The lens is read from its
tensors on any device, widened to float64 as the JAX package does, so one
state gives the same text byte for byte in both packages.
"""

from __future__ import annotations

import math
import re
from typing import Dict

import numpy as np

from ..system import LensSystem


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def lens_header(lens: LensSystem, sensor_height: float = 1.7) -> str:
    """Serialize the compiled lens exactly as ``writeToFile`` does
    (zoic.cpp:1240-1293)."""
    center = _host(lens.center).astype(np.float64)
    curv = _host(lens.curvature).astype(np.float64)
    ap = _host(lens.aperture).astype(np.float64)
    parts = ["LENSMODEL{KOLB}\n"]
    lenses = []
    for c, r, a in zip(center, curv, ap):
        # np.arcsin yields nan outside the domain, like the C std::asin the
        # reference prints unguarded (zoic.cpp:1248)
        angle = math.degrees(float(np.arcsin((a * 0.5) / r)))
        lenses.append(f"{-c:.10f} {-r:.10f} {angle:.10f}")
    parts.append("LENSES{" + " ".join(lenses) + " }\n")
    parts.append("IOR{" + " ".join(f"{v:.10f}" for v in _host(lens.ior))
                 + " }\n")
    parts.append(f"APERTUREELEMENT{{{lens.aperture_element}}}\n")
    parts.append(f"APERTUREDISTANCE{{{-float(lens.aperture_distance):.10f}}}\n")
    parts.append(f"APERTURE{{{float(lens.user_aperture_radius):.10f}}}\n")
    parts.append(f"APERTUREMAX{{{float(np.max(_host(lens.aperture))):.10f}}}\n")
    parts.append(f"FOCUSDISTANCE{{{-float(lens.focal_distance):.10f}}}\n")
    parts.append(f"IMAGEDISTANCE{{{-float(lens.origin_shift):.10f}}}\n")
    parts.append(f"SENSORHEIGHT{{{sensor_height:.10f}}}\n")
    return "".join(parts)


def write(
    path: str,
    lens: LensSystem,
    segments: np.ndarray,
    sensor_height: float = 1.7,
) -> None:
    """Write a full dump: header + RAYS block.  ``segments`` is [S, 4]
    (z1, y1, z2, y2) in the dump's (already negated) convention."""
    with open(path, "w") as f:
        f.write(lens_header(lens, sensor_height))
        f.write("RAYS{")
        flat = np.asarray(segments, np.float64).reshape(-1)
        f.write(" ".join(f"{v:.10f}" for v in flat))
        f.write(" }" if flat.size else "}")


_BLOCK = re.compile(r"(\w+)\{([^}]*)\}")


def parse(text: str) -> Dict[str, np.ndarray]:
    """Parse a ``draw.zoic`` dump (ours or the reference's) into arrays."""
    out: Dict[str, np.ndarray] = {}
    for name, body in _BLOCK.findall(text):
        body = body.strip()
        if name == "LENSMODEL":
            out["LENSMODEL"] = body  # type: ignore[assignment]
            continue
        vals = np.array([float(v) for v in body.split()]) if body else np.empty(0)
        out[name] = vals
    if "LENSES" in out:
        out["LENSES"] = out["LENSES"].reshape(-1, 3)
    if "RAYS" in out:
        n = out["RAYS"].size // 4 * 4
        out["RAYS"] = out["RAYS"][:n].reshape(-1, 4)
    return out


def parse_file(path: str) -> Dict[str, np.ndarray]:
    with open(path) as f:
        return parse(f.read())


def write_thinlens(path: str, segments: np.ndarray) -> None:
    """Thin-lens dump: ``LENSMODEL{THINLENS}`` + RAYS only, as the reference
    writes for the THINLENS branch (zoic.cpp:1600-1604, 1833-1841)."""
    with open(path, "w") as f:
        f.write("LENSMODEL{THINLENS}\nRAYS{")
        flat = np.asarray(segments, np.float64).reshape(-1)
        f.write(" ".join(f"{v:.10f}" for v in flat))
        f.write(" }" if flat.size else "}")


def write_aperture_test(
    path: str,
    gt_points: list,
    ss_points: list,
) -> None:
    """``testApertures.zoic`` format (testAperturesTruth zoic.cpp:1354-1388,
    testAperturesLUT zoic.cpp:1458-1537): per film position one ``GT:`` row
    of surviving first-element points and one ``SS:`` row of LUT-shaped
    samples, x y pairs space-separated.  ``gt_points``/``ss_points`` are
    lists of [N_i, 2] arrays, one per film grid position."""
    with open(path, "w") as f:
        for pts in gt_points:
            f.write("GT: ")
            f.write(" ".join(f"{v:g}" for v in np.asarray(pts).reshape(-1)))
            f.write("\n")
        for pts in ss_points:
            f.write("SS: ")
            f.write(" ".join(f"{v:g}" for v in np.asarray(pts).reshape(-1)))
            f.write("\n")


def parse_aperture_test(path: str):
    """Parse a ``testApertures.zoic`` file (ours or the reference's) into
    (gt_list, ss_list) of [N, 2] arrays."""
    gt, ss = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith("GT:"):
                vals = np.array([float(v) for v in line[3:].split()])
                gt.append(vals.reshape(-1, 2) if vals.size else np.empty((0, 2)))
            elif line.startswith("SS:"):
                vals = np.array([float(v) for v in line[3:].split()])
                ss.append(vals.reshape(-1, 2) if vals.size else np.empty((0, 2)))
    return gt, ss
