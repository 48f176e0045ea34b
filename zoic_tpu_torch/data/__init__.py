"""Lens prescriptions and compiled camera states shipped with the port.

``lenses/*.dat`` are byte copies of the JAX package's eight bundled lens
designs (W. J. Smith, *Modern Lens Design*, McGraw-Hill 1992, plus lens
patents); :data:`LENSES` and :func:`lens_path` name them, with the
published focal lengths that double as golden values of the focal solve.

Each ``.v7.npz`` here is a raytraced camera that the JAX package compiled
(``zoic_tpu.compile_camera``, default LUT samples) and
``tools/export_torch_state.py --config NAME`` wrote.  :data:`CAMERAS`
names them: the headline camera (``double_gauss_f2.0``, focal length 5 cm,
f/2, focus 100 cm, exit-pupil LUT and pupil pre-check on), the eight other
raytraced cameras of ``bench.py --all`` and the headline lens compiled
without the LUT, whose pre-check is fitted for naive first-element
candidates.  :func:`zoic_tpu_torch.compile_camera` rebuilds every one of
them from its lens file; the files stay as the parity anchor of that
compile.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, NamedTuple, Optional

import numpy as np

_HERE = os.path.dirname(__file__)


@dataclasses.dataclass(frozen=True)
class LensInfo:
    name: str
    path: str
    efl_mm: float                 # published effective focal length
    bfl_mm: Optional[float]       # published back focal length (if given)
    fstop: float                  # max numerical aperture
    elements: int                 # element rows incl. iris


def _p(fname: str) -> str:
    return os.path.join(_HERE, "lenses", fname)


LENSES: Dict[str, LensInfo] = {
    info.name: info
    for info in [
        LensInfo("petzval_f1.25", _p("petzval_f1.25.dat"), 99.5, 1.665, 1.25, 11),
        LensInfo("petzval_f1.6", _p("petzval_f1.6.dat"), 100.7, 15.72, 1.6, 8),
        LensInfo("double_gauss_f2.0", _p("double_gauss_f2.0.dat"), 100.0, None, 2.0, 11),
        LensInfo("triplet_f2.5", _p("triplet_f2.5.dat"), 99.58, 65.48, 2.5, 7),
        LensInfo("mori_f2.8", _p("mori_f2.8.dat"), 100.0, 129.3, 2.8, 11),
        LensInfo("tessar_f2.8", _p("tessar_f2.8.dat"), 100.0, 79.83, 2.8, 8),
        LensInfo("fisheye_muller_f4.0", _p("fisheye_muller_f4.0.dat"), 10.0, None, 4.0, 12),
        LensInfo("telephoto_f5.0", _p("telephoto_f5.0.dat"), 100.0, 42.9, 5.0, 9),
    ]
}


def lens_path(name: str) -> str:
    """Path of a bundled lens prescription ``lenses/<name>.dat``."""
    return LENSES[name].path


class Camera(NamedTuple):
    """A shipped state and the camera config it was compiled from."""

    file: str
    lens: str               # prescription lenses/<lens>.dat (LENSES)
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
