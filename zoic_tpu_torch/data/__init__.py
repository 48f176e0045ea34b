"""Compiled camera states shipped with the port.

Each ``.v7.npz`` here is a raytraced camera that the JAX package compiled
(``zoic_tpu.compile_camera``, default LUT samples) and
``tools/export_torch_state.py --config NAME`` wrote.  :data:`CAMERAS`
names them: the headline camera (``double_gauss_f2.0``, focal length 5 cm,
f/2, focus 100 cm, exit-pupil LUT and pupil pre-check on), the eight other
raytraced cameras of ``bench.py --all`` and the headline lens compiled
without the LUT, whose pre-check is fitted for naive first-element
candidates.
"""

from __future__ import annotations

import os
from typing import Dict, NamedTuple

import numpy as np

_HERE = os.path.dirname(__file__)


class Camera(NamedTuple):
    """A shipped state and the camera config it was compiled from."""

    file: str
    lens: str               # prescription in zoic_tpu/data/lenses/<lens>.dat
    focal_length: float     # cm
    fstop: float
    focal_distance: float   # cm
    kolb_sampling_lut: bool = True
    use_image: bool = False  # image bokeh from bokeh_disk(64)

    def config_kwargs(self) -> dict:
        """Keyword arguments of ``CameraConfig`` for this camera, in either
        package, but for ``lens_data_path`` and ``bokeh_path``."""
        return dict(focal_length=self.focal_length, fstop=self.fstop,
                    focal_distance=self.focal_distance,
                    kolb_sampling_lut=self.kolb_sampling_lut,
                    use_image=self.use_image)


def _sweep() -> Dict[str, Camera]:
    out = {}
    for lens, focal, fstop in (("petzval_f1.25", 5.0, 1.25),
                               ("telephoto_f5.0", 10.0, 5.0)):
        for focus in (30.0, 100.0, 1000.0):
            out[f"raytraced_{lens}_focus{focus:g}"] = Camera(
                f"{lens}_fl{focal:g}_f{fstop:g}_fd{focus:g}.v7.npz",
                lens, focal, fstop, focus)
    return out


CAMERAS: Dict[str, Camera] = {
    "headline": Camera("double_gauss_f2.0_fl5_f2_fd100.v7.npz",
                       "double_gauss_f2.0", 5.0, 2.0, 100.0),
    "raytraced_fisheye": Camera("fisheye_muller_f4.0_fl1_f4_fd100.v7.npz",
                                "fisheye_muller_f4.0", 1.0, 4.0, 100.0),
    "raytraced_bokeh_image": Camera(
        "double_gauss_f2.0_fl5_f2_fd100_bokeh64.v7.npz",
        "double_gauss_f2.0", 5.0, 2.0, 100.0, use_image=True),
    **_sweep(),
    "raytraced_naive": Camera("double_gauss_f2.0_fl5_f2_fd100_naive.v7.npz",
                              "double_gauss_f2.0", 5.0, 2.0, 100.0,
                              kolb_sampling_lut=False),
}

HEADLINE = CAMERAS["headline"].file


def state_path(name: str = HEADLINE) -> str:
    """Path of a shipped state, by file name or by :data:`CAMERAS` key."""
    if name in CAMERAS:
        name = CAMERAS[name].file
    path = os.path.join(_HERE, name)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no shipped state named {name!r}")
    return path


def bokeh_disk(n: int = 64) -> np.ndarray:
    """The benchmark's bokeh image (``bench.py --all``): a disk of radius
    sqrt(0.8) on an ``n`` x ``n`` grid over [-1, 1]^2, as ``[n, n, 3]``."""
    yy, xx = np.mgrid[-1:1:n * 1j, -1:1:n * 1j]
    img = ((xx**2 + yy**2) < 0.8).astype(np.float32)
    return np.stack([img, img, img], -1)
