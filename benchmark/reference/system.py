"""Frozen copy of the port's state containers (``zoic_tpu_torch/system.py``), for
the benchmark's plain reference: it imports nothing of the port, so a
later change to the port cannot move the yardstick.  The original
docstring follows.

Compiled lens state, as plain dataclasses of tensors.

The counterparts of ``zoic_tpu/system.py``: the same containers and field
names, with every array a ``torch.Tensor`` on one device and the static
(shape-deciding) fields kept as Python values.

The copy keeps the containers and leaves out the port's state bridge.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

Tensor = torch.Tensor


def _to(obj, device):
    """Copy of a dataclass with every tensor (recursively) on ``device``."""
    changes = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            changes[f.name] = v.to(device)
        elif dataclasses.is_dataclass(v):
            changes[f.name] = _to(v, device)
    return dataclasses.replace(obj, **changes)


class _ToDevice:
    def to(self, device):
        return _to(self, torch.device(device))


@dataclasses.dataclass(frozen=True)
class PupilLUT(_ToDevice):
    """Exit-pupil lookup table over uniformly spaced film-radius keys."""

    keys: Tensor        # f32[n]  film-x sample positions (i * spacing)
    max_scale: Tensor   # f32[n]  boundingBox2d::getMaxScale()
    centroid_x: Tensor  # f32[n]  boundingBox2d::getCentroid().x
    bbox_min_x: Tensor
    bbox_min_y: Tensor
    bbox_max_x: Tensor
    bbox_max_y: Tensor


@dataclasses.dataclass(frozen=True)
class PupilProfile(_ToDevice):
    """Pupil-support outer bound per film radius (the retry pre-check).
    ``kind == "circles"`` holds ``(a1, q1, a2, q2)`` in the
    ``(c0, c1, c2, c4)`` slots; see ``zoic_tpu.system.PupilProfile``."""

    keys: Tensor
    c0: Tensor
    c1: Tensor
    c2: Tensor
    c4: Tensor
    poly: Optional[Tensor] = None        # f32[4, D+1] Horner coefficients
    poly_scale: Optional[Tensor] = None  # f32[] fit-domain radius
    kind: str = "harmonic"


@dataclasses.dataclass(frozen=True)
class LensSystem(_ToDevice):
    """Struct-of-arrays compiled lens stack, rear element first, in cm."""

    curvature: Tensor            # f32[E] signed radius of curvature
    thickness: Tensor            # f32[E] axial gap
    ior: Tensor                  # f32[E]
    abbe: Tensor                 # f32[E]
    aperture: Tensor             # f32[E] clear-aperture diameter
    center: Tensor               # f32[E] sphere-center z
    user_aperture_radius: Tensor  # f32[] iris radius from fStop
    origin_shift: Tensor         # f32[] film-plane z
    aperture_distance: Tensor    # f32[]
    focal_length_ratio: Tensor   # f32[]
    traced_focal_length: Tensor  # f32[]
    film_diagonal: Tensor        # f32[]
    focal_distance: Tensor       # f32[]
    lut: Optional[PupilLUT]
    profile: Optional[PupilProfile] = None
    # static metadata (see zoic_tpu.system.LensSystem for each one's use)
    aperture_element: int = -1
    dead_frac: float = 0.0
    iris_identity: bool = False
    elem_flags: Tuple[int, ...] = ()
    profile_domain: str = "disk"
    profile_poly: bool = False

    @property
    def count(self) -> int:
        return int(self.curvature.shape[0])


@dataclasses.dataclass(frozen=True)
class BokehImage(_ToDevice):
    """Image-bokeh sampler tables (``zoic_tpu.system.BokehImage``), built on
    the host by :func:`zoic_tpu_torch.bokeh.build`.  ``dx_col`` and
    ``dy_srow`` hold the final [-1, 1] offsets computed with host true f32
    division, so sampling only selects values and never divides."""

    cdf_row: Tensor      # f32[h]    row CDF over sorted row sums
    row_indices: Tensor  # i32[h]    descending-sum row order
    cdf_col: Tensor      # f32[h, w] per-row CDF over sorted columns
    col_indices: Tensor  # i32[h, w] per-row descending column order (global)
    dx_col: Tensor       # f32[h, w] final dx per (row, sorted column)
    dy_srow: Tensor      # f32[h]    final dy per sorted row index
    width: int = 0
    height: int = 0


@dataclasses.dataclass(frozen=True)
class CameraState(_ToDevice):
    """Everything ``create_rays`` needs, on one device."""

    fov: Tensor
    tan_fov: Tensor
    aperture_radius: Tensor
    sensor_width: Tensor
    sensor_height: Tensor
    focal_distance: Tensor
    ov_distance: Tensor
    ov_radius: Tensor
    exposure_control: Tensor
    lens: Optional[LensSystem]
    bokeh: Optional[BokehImage] = None

    @property
    def device(self) -> torch.device:
        return self.sensor_width.device
