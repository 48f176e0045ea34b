"""Compile raytraced cameras with the JAX package and write their states for
the PyTorch port.

The port (``zoic_tpu_torch``) has no lens-compile pipeline yet, so it reads
a ``CameraState`` that ``zoic_tpu.compile_camera`` built and
``zoic_tpu.io.state.save`` wrote (format v7).  This script regenerates the
committed files under ``zoic_tpu_torch/data/``, one camera or all of them:

    env JAX_PLATFORMS=cpu python tools/export_torch_state.py
    env JAX_PLATFORMS=cpu python tools/export_torch_state.py --config raytraced_fisheye

The cameras are ``zoic_tpu_torch.data.CAMERAS``: the headline camera that
``bench.py`` and ``__graft_entry__.entry()`` run (``double_gauss_f2.0`` at
focal length 5 cm, f/2, focus 100 cm), the other raytraced cameras of
``bench.py --all`` (the image-bokeh one with the benchmark's 64x64 disk)
and the headline lens without the exit-pupil LUT.  Each is compiled with
the pupil pre-check on and the default LUT samples, as ``bench.py`` does.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

import zoic_tpu as zt  # noqa: E402
from zoic_tpu.io import state as state_io  # noqa: E402
from zoic_tpu_torch.data import CAMERAS, bokeh_disk  # noqa: E402

DATA = os.path.join(os.path.dirname(__file__), "..", "zoic_tpu_torch", "data")


def camera_config(name: str, bokeh_path: str = "") -> zt.CameraConfig:
    """The JAX package's config of camera ``name``; ``bokeh_path`` is the
    image file of a camera with ``use_image``."""
    cam = CAMERAS[name]
    return zt.CameraConfig(
        lens_model=zt.LensModel.RAYTRACED,
        lens_data_path=zt.data.lens_path(cam.lens),
        bokeh_path=bokeh_path if cam.use_image else "",
        **cam.config_kwargs(),
    )


def export(name: str, out_dir: str = DATA) -> str:
    with tempfile.TemporaryDirectory() as tmp:
        bokeh_path = os.path.join(tmp, "bokeh_disk64.npy")
        np.save(bokeh_path, bokeh_disk(64))
        state = zt.compile_camera(camera_config(name, bokeh_path))
    out = os.path.join(out_dir, CAMERAS[name].file)
    state_io.save(out, state)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", choices=sorted(CAMERAS), action="append",
                    help="camera to export (repeatable); default: all")
    ap.add_argument("--out-dir", default=DATA)
    args = ap.parse_args()
    for name in args.config or list(CAMERAS):
        out = export(name, args.out_dir)
        print(f"{name}: wrote {os.path.normpath(out)} "
              f"({os.path.getsize(out)} bytes)", flush=True)


if __name__ == "__main__":
    main()
