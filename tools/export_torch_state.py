"""Compile the headline raytraced camera with the JAX package and write its
state for the PyTorch port.

The port (``zoic_tpu_torch``) has no lens-compile pipeline yet, so it reads
a ``CameraState`` that ``zoic_tpu.compile_camera`` built and
``zoic_tpu.io.state.save`` wrote (format v7).  This script regenerates the
committed file:

    env JAX_PLATFORMS=cpu python tools/export_torch_state.py

The config is the one ``bench.py`` and ``__graft_entry__.entry()`` run:
``double_gauss_f2.0`` at focal length 5 cm, f/2, focus 100 cm, exit-pupil
LUT and pupil pre-check on, default LUT keys.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import zoic_tpu as zt  # noqa: E402
from zoic_tpu.io import state as state_io  # noqa: E402

NAME = "double_gauss_f2.0_fl5_f2_fd100.v7.npz"


def headline_config() -> zt.CameraConfig:
    return zt.CameraConfig(
        lens_model=zt.LensModel.RAYTRACED,
        lens_data_path=zt.data.lens_path("double_gauss_f2.0"),
        focal_length=5.0,
        fstop=2.0,
        focal_distance=100.0,
        kolb_sampling_lut=True,
    )


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--out",
        default=os.path.join(
            os.path.dirname(__file__), "..", "zoic_tpu_torch", "data", NAME
        ),
    )
    args = ap.parse_args()
    state = zt.compile_camera(headline_config())
    state_io.save(args.out, state)
    print(f"wrote {os.path.normpath(args.out)} "
          f"({os.path.getsize(args.out)} bytes)")


if __name__ == "__main__":
    main()
