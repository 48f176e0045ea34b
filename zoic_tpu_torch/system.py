"""Compiled lens state, as plain dataclasses of tensors.

The counterparts of ``zoic_tpu/system.py``: the same containers and field
names, with every array a ``torch.Tensor`` on one device and the static
(shape-deciding) fields kept as Python values.

The state bridge (:func:`camera_state_from_numpy`) builds a
:class:`CameraState` from named numpy arrays plus the static fields, which
is how a state compiled by the JAX package enters the port
(:mod:`zoic_tpu_torch.io.state`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

Tensor = torch.Tensor


def _to(obj, device):
    """Copy of a dataclass with every tensor (recursively) on ``device``."""
    changes = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            # a copy to a card need not wait for it; one to the host must
            changes[f.name] = v.to(device,
                                   non_blocking=v.device.type == "cpu")
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


@dataclasses.dataclass(frozen=True)
class RayBatch:
    """Batched camera rays: origin/dir/weight and the fake derivatives."""

    origin: Tensor  # f32[B, 3]
    dir: Tensor     # f32[B, 3]
    weight: Tensor  # f32[B]
    d_ody: Tensor   # f32[B, 3]
    d_ddy: Tensor   # f32[B, 3]


@dataclasses.dataclass(frozen=True)
class RayStats:
    """Run counters as int32 scalar tensors."""

    success: Tensor
    vignetted: Tensor
    tir: Tensor
    tries_total: Tensor  # retry draws beyond the first attempt

    def vignetted_percent(self) -> Tensor:
        """Vignetted rays as a percentage of the rays counted, 0 when none
        were (the ``node_finish`` report's percentage)."""
        denom = self.success.to(torch.float32) + self.vignetted.to(
            torch.float32)
        return torch.where(denom > 0, self.vignetted / denom * 100.0,
                           torch.zeros_like(denom))


# ---------------------------------------------------------------- bridge

_LUT_FIELDS = [f.name for f in dataclasses.fields(PupilLUT)]
_PROFILE_FIELDS = ["keys", "c0", "c1", "c2", "c4", "poly", "poly_scale"]
_LENS_FIELDS = [
    f.name for f in dataclasses.fields(LensSystem)
    if f.name not in ("lut", "profile") and f.type == "Tensor"
]
_BOKEH_FIELDS = [
    f.name for f in dataclasses.fields(BokehImage) if f.type == "Tensor"
]
_STATE_FIELDS = [
    f.name for f in dataclasses.fields(CameraState) if f.type == "Tensor"
]


def leaf_names(static: dict) -> List[str]:
    """Array names in ``jax.tree_util`` flatten order of the JAX package's
    ``CameraState``: dataclass field order, ``None`` subtrees dropped."""
    names = list(_STATE_FIELDS)
    if static["has_lens"]:
        names += [f"lens.{n}" for n in _LENS_FIELDS]
        if static["has_lut"]:
            names += [f"lens.lut.{n}" for n in _LUT_FIELDS]
        if static["has_profile"]:
            names += [f"lens.profile.{n}" for n in _PROFILE_FIELDS]
    if static.get("has_bokeh"):
        names += [f"bokeh.{n}" for n in _BOKEH_FIELDS]
    return names


def camera_state_from_numpy(
    arrays: Dict[str, np.ndarray], static: dict, device
) -> CameraState:
    """Build a :class:`CameraState` on ``device`` from named arrays
    (``"fov"``, ``"lens.curvature"``, ``"lens.lut.keys"``,
    ``"bokeh.cdf_row"``, ...; see :func:`leaf_names`) and the static fields
    of the JAX package's state file (``has_lens``, ``aperture_element``,
    ``elem_flags``, ``bokeh_wh``, ...)."""
    device = torch.device(device)
    expected = leaf_names(static)
    if sorted(arrays) != sorted(expected):
        raise ValueError(
            f"state arrays {sorted(arrays)} do not match the static "
            f"layout {sorted(expected)}"
        )

    def t(name):
        return torch.from_numpy(np.array(arrays[name], copy=True)).to(device)

    lens = None
    if static["has_lens"]:
        lut = (
            PupilLUT(*[t(f"lens.lut.{n}") for n in _LUT_FIELDS])
            if static["has_lut"] else None
        )
        profile = (
            PupilProfile(
                *[t(f"lens.profile.{n}") for n in _PROFILE_FIELDS],
                kind=static["profile_kind"],
            )
            if static["has_profile"] else None
        )
        lens = LensSystem(
            *[t(f"lens.{n}") for n in _LENS_FIELDS],
            lut=lut,
            profile=profile,
            aperture_element=int(static["aperture_element"]),
            dead_frac=float(static["dead_frac"]),
            iris_identity=bool(static["iris_identity"]),
            elem_flags=tuple(int(f) for f in static["elem_flags"]),
            profile_domain=str(static["profile_domain"]),
            profile_poly=bool(static["profile_poly"]),
        )
    bokeh = None
    if static.get("has_bokeh"):
        width, height = static["bokeh_wh"]
        bokeh = BokehImage(*[t(f"bokeh.{n}") for n in _BOKEH_FIELDS],
                           width=int(width), height=int(height))
    return CameraState(*[t(n) for n in _STATE_FIELDS], lens=lens,
                       bokeh=bokeh)
