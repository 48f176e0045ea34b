"""Compiled camera states shipped with the port.

``double_gauss_f2.0_fl5_f2_fd100.v7.npz`` is the headline raytraced camera
(``double_gauss_f2.0``, focal length 5 cm, f/2, focus 100 cm, exit-pupil
LUT and pupil pre-check on), compiled by the JAX package and written by
``tools/export_torch_state.py``.
"""

from __future__ import annotations

import os

_HERE = os.path.dirname(__file__)

HEADLINE = "double_gauss_f2.0_fl5_f2_fd100.v7.npz"


def state_path(name: str = HEADLINE) -> str:
    path = os.path.join(_HERE, name)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no shipped state named {name!r}")
    return path
