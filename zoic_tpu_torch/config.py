"""Camera configuration schema.

A copy of ``zoic_tpu/config.py``, which is pure Python but cannot be
imported from ``zoic_tpu`` without importing jax (``zoic_tpu/__init__.py``).
The schema and its validation are the same; the debug hooks it names exist
only in ``zoic_tpu`` so far.

Equivalent of the reference's three config layers (see SURVEY.md §5
"Config / flag system"): the Arnold node parameters + ``.mtd`` UI metadata
(reference: src/zoic.cpp:1547-1562 declares the 14 parameters and defaults,
src/zoic.mtd:17-155 holds validation ranges) collapse into a single frozen
dataclass with validation.  Compile-time feature flags of the reference
(``_DRAW``/``_DEBUGIMAGESAMPLING``, zoic.cpp:31-57) become runtime options on
:class:`DebugOptions`.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Tuple


class LensModel(enum.Enum):
    """Lens model selector (reference: zoic.cpp:84-97 ``enum LensModel``)."""

    THINLENS = 0
    RAYTRACED = 1


# Full per-attribute UI schema lifted from the reference metadata file
# (src/zoic.mtd:17-155): hard range (min/max), soft UI-slider range
# (softmin/softmax, None where the .mtd omits one), the .mtd default, and
# the user-facing description string.  Keys are the config field names;
# ``attr`` is the Arnold attribute name the .mtd block declares.  Note the
# .mtd defaults differ from the node_parameters defaults in places
# (focalLength 3.5 vs 2.0, fStop 2.8 vs 4.0, focalDistance 120 vs 100 —
# zoic.cpp:1547-1562 is what the plugin actually instantiates, so
# CameraConfig uses those); the .mtd default is carried here verbatim as
# UI metadata only.
PARAM_SCHEMA = {
    "sensor_width": {
        "attr": "sensorWidth", "min": 0.1, "max": 10.0,
        "softmin": None, "softmax": None, "default": 3.6,
        "desc": "Width of the sensor in centimeters. Default value is the "
                "width of a full frame sensor.",
    },
    "sensor_height": {
        "attr": "sensorHeight", "min": 0.1, "max": 10.0,
        "softmin": None, "softmax": None, "default": 2.4,
        "desc": "Height of the sensor in centimeters. Default value is the "
                "height of a full frame sensor.",
    },
    "focal_length": {
        "attr": "focalLength", "min": 0.1, "max": 100.0,
        "softmin": 0.8, "softmax": 20.0, "default": 3.5,
        "desc": "Distance between the lens and the point at which the light "
                "converges in millimeters.",
    },
    "fstop": {
        "attr": "fStop", "min": 0.01, "max": 100.0,
        "softmin": 0.7, "softmax": 32.0, "default": 2.8,
        "desc": "Ratio of the distance from the lens to the point where the "
                "focused light converges (the focal length) over the "
                "diameter of the aperture.",
    },
    "focal_distance": {
        "attr": "focalDistance", "min": 0.001, "max": 99999.0,
        "softmin": None, "softmax": None, "default": 120.0,
        "desc": "Distance between lens and object in focus in millimeters.",
    },
    "use_image": {
        "attr": "useImage", "min": None, "max": None,
        "softmin": None, "softmax": None, "default": False,
        "desc": "Enable Image based bokeh",
    },
    "bokeh_path": {
        "attr": "bokehPath", "min": None, "max": None,
        "softmin": None, "softmax": None, "default": "",
        "desc": "Path to bokeh image. No need to convert to .tx",
    },
    "lens_model": {
        "attr": "lensModel", "min": None, "max": None,
        "softmin": None, "softmax": None, "default": "RAYTRACED",
        "desc": "Lens Model",
    },
    "lens_data_path": {
        "attr": "lensDataPath", "min": None, "max": None,
        "softmin": None, "softmax": None, "default": "",
        "desc": "Path to lens data file",
    },
    "kolb_sampling_lut": {
        "attr": "kolbSamplingLUT", "min": None, "max": None,
        "softmin": None, "softmax": None, "default": True,
        "desc": "Use lookup table",
    },
    "use_dof": {
        "attr": "useDof", "min": None, "max": None,
        "softmin": None, "softmax": None, "default": True,
        "desc": "Enable Depth of Field",
    },
    "optical_vignetting_distance": {
        "attr": "opticalVignettingDistance", "min": 0.0, "max": 1000.0,
        "softmin": None, "softmax": 50.0, "default": 0.0,
        "desc": "Sometimes referred to as the cat-eye effect, this is a lens "
                "imperfection that is not caused by the glass but by the "
                "outer edge of the lens, also known as the exit aperture. "
                "When the main aperture is fully open, light coming into the "
                "camera from steep angles will be blocked partially by the "
                "edge of the lens. This creates cat-eye like bokeh shapes "
                "near the edges of an image. It should be noted that this "
                "lens effect is purely mechanical and can not be confused "
                "with lens distortion.",
    },
    "optical_vignetting_radius": {
        "attr": "opticalVignettingRadius", "min": 1.0, "max": 5.0,
        "softmin": None, "softmax": 2.0, "default": 1.0,
        "desc": "A multiplier on the actual aperture radius to determine the "
                "size of the virtual aperture.",
    },
    "exposure_control": {
        "attr": "exposureControl", "min": -100.0, "max": 100.0,
        "softmin": -5.0, "softmax": 5.0, "default": 0.0,
        "desc": "Multiplier on the ray weight.",
    },
}

# Validation ranges enforced at construction time.  Mostly the .mtd hard
# bounds; focal_distance / optical-vignetting bounds are relaxed where the
# plugin code itself accepts the wider value (the .mtd bound is a UI
# constraint, not a numerics one — PARAM_SCHEMA carries it verbatim).
_RANGES = {
    "sensor_width": (0.1, 10.0),        # zoic.mtd [attr sensorWidth]
    "sensor_height": (0.1, 10.0),       # zoic.mtd [attr sensorHeight]
    "focal_length": (0.1, 100.0),       # zoic.mtd [attr focalLength]
    "fstop": (0.01, 100.0),             # zoic.mtd [attr fStop]
    "focal_distance": (0.0, float("inf")),
    "optical_vignetting_distance": (0.0, float("inf")),
    "optical_vignetting_radius": (0.0, float("inf")),
    "exposure_control": (-float("inf"), float("inf")),
}


@dataclasses.dataclass(frozen=True)
class DebugOptions:
    """Runtime replacements for the reference's compile-time debug flags.

    ``draw`` mirrors ``_DRAW`` (zoic.cpp:53-57): when enabled,
    :meth:`zoic_tpu.camera.Camera.create_rays` additionally records a ray
    tape (per-element hit segments) for a 1-in-``draw_stride`` sub-batch of
    each generation — the vectorized analog of dumping every 100,000th ray
    (zoic.cpp:1758-1764) — and :meth:`Camera.finish` writes the accumulated
    ``draw.zoic`` dump and renders the ray-diagram PNG, reproducing the
    reference's render-then-auto-draw flow (zoic.cpp:1741-1745).  The
    functional ``create_rays`` stays pure; use
    :func:`zoic_tpu.diag.session.render_debug_session` for a one-call
    equivalent without the stateful wrapper.

    ``image_sampling_trace`` mirrors ``_DEBUGIMAGESAMPLING``
    (zoic.cpp:47-51, 248-409): a path that receives every bokeh-CDF build
    intermediate (luminance, normalized PDF, row sums, sorted row CDF,
    per-row normalized values, column CDFs) when the bokeh image is
    compiled — see ``bokeh.build(trace=...)``.
    """

    draw: bool = False
    draw_stride: int = 100_000  # reference dumps 1 ray per 100k (zoic.cpp:1760)
    image_sampling_trace: str | None = None


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """The 14 user parameters of the reference camera, with their defaults.

    Reference declaration and defaults: src/zoic.cpp:1547-1562
    (``node_parameters``).  Units follow the reference: centimeters for
    sensor/focal sizes, and the lens ``.dat`` files are in millimeters
    (converted on load, zoic.cpp:946-950).
    """

    sensor_width: float = 3.6            # cm, full-frame width
    sensor_height: float = 2.4           # cm, full-frame height
    focal_length: float = 2.0            # cm (reference default 2.0)
    fstop: float = 4.0
    focal_distance: float = 100.0        # cm
    use_image: bool = False              # image-based bokeh on/off
    bokeh_path: str = ""                 # path to bokeh image
    lens_model: LensModel = LensModel.RAYTRACED
    lens_data_path: str = ""             # path to tabular lens .dat
    kolb_sampling_lut: bool = True       # exit-pupil LUT on/off
    use_dof: bool = True                 # depth of field on/off
    optical_vignetting_distance: float = 0.0
    optical_vignetting_radius: float = 1.0
    exposure_control: float = 0.0

    # --- framework-side knobs (no reference equivalent) ---
    max_tries: int = 25                  # resample budget (zoic.cpp:1767)
    impl: str = "auto"                   # "auto" | "jnp" | "pallas"
    # polar pupil pre-check: consume provably-failing tries without tracing
    # (exact per-try outcomes; see PupilProfile / PARITY.md)
    pupil_precheck: bool = True
    lut_film_samples: int = 32           # exitPupilLUT(ld, 32, ...) zoic.cpp:1692
    lut_bounds_samples: int = 100_000    # exitPupilLUT(ld, ..., 100000)
    debug: DebugOptions = dataclasses.field(default_factory=DebugOptions)

    def __post_init__(self):
        for name, (lo, hi) in _RANGES.items():
            v = getattr(self, name)
            if not (lo <= v <= hi):
                raise ValueError(
                    f"CameraConfig.{name}={v} outside valid range [{lo}, {hi}]"
                )
        if self.lens_model is LensModel.RAYTRACED and not self.lens_data_path:
            # reference aborts the render in this case (zoic.cpp:1639-1641)
            raise ValueError(
                "lens_data_path is required for the RAYTRACED lens model"
            )
        if self.use_image and not self.bokeh_path:
            raise ValueError("bokeh_path is required when use_image=True")
        if self.max_tries < 0:
            raise ValueError("max_tries must be >= 0")
        if self.impl not in ("auto", "jnp", "pallas"):
            raise ValueError(f"impl must be auto|jnp|pallas, got {self.impl!r}")

    # The reference recomputes lens setup only when one of these changed
    # (cameraParams::lensChanged, zoic.cpp:595-606).  We key the compiled-lens
    # cache on the same tuple.
    def lens_key(self) -> Tuple:
        return (
            self.sensor_width,
            self.sensor_height,
            self.focal_length,
            self.fstop,
            self.focal_distance,
            self.use_image,
            self.bokeh_path if self.use_image else None,
            self.lens_model,
            self.lens_data_path if self.lens_model is LensModel.RAYTRACED else None,
            self.kolb_sampling_lut if self.lens_model is LensModel.RAYTRACED else None,
        )

    # cameraParams::bokehChanged (zoic.cpp:608-611)
    def bokeh_key(self) -> Tuple:
        return (self.use_image, self.bokeh_path if self.use_image else None)

    # The subset of lens_key the LENS-SOLVE pipeline actually reads: the
    # bokeh image path only feeds the sampler state, never the solve
    # (``use_image`` stays — it selects the pre-check profile's fit
    # domain, compile_camera).  Camera.update uses this to rebuild only
    # the bokeh state on a bokeh-path-only change.
    def solve_key(self) -> Tuple:
        k = self.lens_key()
        return k[:6] + k[7:]

    def replace(self, **kw) -> "CameraConfig":
        return dataclasses.replace(self, **kw)
