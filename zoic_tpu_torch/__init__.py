"""zoic_tpu_torch: the PyTorch / CUDA port of zoic-tpu for NVIDIA Hopper.

It sits beside the JAX package ``zoic_tpu``, keeps its module names, and
imports neither jax nor ``zoic_tpu``.  Both camera models run end to end
from their config: the raytraced one compiles its lens from a lens file
(solve, exit-pupil LUT, pupil pre-check) on the card::

    import torch
    import zoic_tpu_torch as zt

    cfg = zt.CameraConfig(
        lens_model=zt.LensModel.RAYTRACED,
        lens_data_path=zt.data.lens_path("double_gauss_f2.0"),
        focal_length=5.0, fstop=2.0, focal_distance=100.0,
    )
    state = zt.compile_camera(cfg)          # on "cuda" unless asked
    g = torch.Generator(device="cuda").manual_seed(0)
    rays, stats = zt.create_rays(state, cfg, sx, sy, lensx, lensy,
                                 generator=g)

and the thin-lens model (pinhole, depth of field, empirical vignetting,
image bokeh) the same way with ``lens_model=zt.LensModel.THINLENS``.
``zt.load_state(zt.data.state_path(name))`` reads a state the JAX package
compiled (the shipped ones anchor the compile's parity).

On CUDA tensors the per-ray work runs in the hand-written kernels
``csrc/raytraced.cu``, ``csrc/thinlens.cu`` and ``csrc/bokeh.cu``, built
with ``nvcc`` at first use; on CPU tensors in their plain PyTorch versions.
``python -m zoic_tpu_torch.bench`` times the benchmark's cameras and
``python -m zoic_tpu_torch.tools.roofline`` the card's op rates
(``csrc/roofline.cu``).
"""

from . import bokeh, data, io
from .camera import Camera, compile_camera, create_rays
from .config import CameraConfig, DebugOptions, LensModel
from .io.state import load as load_state
from .system import (BokehImage, CameraState, LensSystem, PupilLUT,
                     PupilProfile, RayBatch, RayStats)

__all__ = [
    "BokehImage",
    "Camera",
    "CameraConfig",
    "CameraState",
    "DebugOptions",
    "LensModel",
    "LensSystem",
    "PupilLUT",
    "PupilProfile",
    "RayBatch",
    "RayStats",
    "bokeh",
    "compile_camera",
    "create_rays",
    "data",
    "io",
    "load_state",
]
