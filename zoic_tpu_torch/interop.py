"""DCC-style parameter conversion helpers.

The port's own copy of ``zoic_tpu/interop.py`` (pure Python, but importing
it through ``zoic_tpu`` imports jax), on the port's ``config.PARAM_SCHEMA``.

The reference ships Maya/C4D integration shims whose only logic is unit
conversion when wiring a DCC camera into the shader
(maya/scripts/makeZoicCamera.mel: focal length mm -> cm via /10, film
aperture inches -> cm via *2.54, plus pass-through of depthOfField /
focusDistance / fStop; the AE template and C4D resource files are pure UI).
These helpers reproduce those conversions so a user coming from the
reference's DCC workflow gets identical configurations.
"""

from __future__ import annotations

from .config import PARAM_SCHEMA, CameraConfig, LensModel


def from_maya_camera(
    focal_length_mm: float,
    horizontal_film_aperture_in: float,
    vertical_film_aperture_in: float,
    focus_distance: float = 100.0,
    f_stop: float = 4.0,
    depth_of_field: bool = True,
    lens_model: LensModel = LensModel.THINLENS,
    lens_data_path: str = "",
    **extra,
) -> CameraConfig:
    """Convert Maya camera attributes exactly as ``makeZoicCamera.mel``
    does: focal mm -> cm, film aperture inch -> cm."""
    return CameraConfig(
        focal_length=focal_length_mm / 10.0,
        sensor_width=horizontal_film_aperture_in * 2.54,
        sensor_height=vertical_film_aperture_in * 2.54,
        focal_distance=focus_distance,
        fstop=f_stop,
        use_dof=depth_of_field,
        lens_model=lens_model,
        lens_data_path=lens_data_path,
        **extra,
    )


def to_node_parameters(config: CameraConfig) -> dict:
    """Render the config as the reference's Arnold node-parameter dict
    (names and value conventions from zoic.cpp:1547-1562) — useful for
    exporting a scene back to the C++ plugin for comparison renders."""
    return {
        "sensorWidth": config.sensor_width,
        "sensorHeight": config.sensor_height,
        "focalLength": config.focal_length,
        "fStop": config.fstop,
        "focalDistance": config.focal_distance,
        "useImage": config.use_image,
        "bokehPath": config.bokeh_path,
        "lensModel": config.lens_model.value,
        "lensDataPath": config.lens_data_path,
        "kolbSamplingLUT": config.kolb_sampling_lut,
        "useDof": config.use_dof,
        "opticalVignettingDistance": config.optical_vignetting_distance,
        "opticalVignettingRadius": config.optical_vignetting_radius,
        "exposureControl": config.exposure_control,
    }


def node_parameter_schema(config: CameraConfig | None = None) -> dict:
    """The reference's full UI metadata per Arnold attribute
    (src/zoic.mtd:17-155): hard min/max, soft UI-slider range, .mtd
    default, and description string — keyed by Arnold attr name, with the
    current config value attached when ``config`` is given.  This is the
    schema a DCC front-end (the Maya AE template / C4D .res files, C24/C25)
    would render."""
    values = to_node_parameters(config) if config is not None else {}
    out = {}
    for field, meta in PARAM_SCHEMA.items():
        entry = {k: v for k, v in meta.items() if k != "attr"}
        if meta["attr"] in values:
            entry["value"] = values[meta["attr"]]
        out[meta["attr"]] = entry
    return out


def from_node_parameters(params: dict, **extra) -> CameraConfig:
    """Inverse of :func:`to_node_parameters`: ingest a reference-style
    parameter dict (e.g. scraped from an .ass scene file)."""
    return CameraConfig(
        sensor_width=params.get("sensorWidth", 3.6),
        sensor_height=params.get("sensorHeight", 2.4),
        focal_length=params.get("focalLength", 2.0),
        fstop=params.get("fStop", 4.0),
        focal_distance=params.get("focalDistance", 100.0),
        use_image=params.get("useImage", False),
        bokeh_path=params.get("bokehPath", ""),
        lens_model=LensModel(params.get("lensModel", 1)),
        lens_data_path=params.get("lensDataPath", ""),
        kolb_sampling_lut=params.get("kolbSamplingLUT", True),
        use_dof=params.get("useDof", True),
        optical_vignetting_distance=params.get("opticalVignettingDistance", 0.0),
        optical_vignetting_radius=params.get("opticalVignettingRadius", 1.0),
        exposure_control=params.get("exposureControl", 0.0),
        **extra,
    )
