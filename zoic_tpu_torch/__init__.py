"""zoic_tpu_torch: the PyTorch / CUDA port of zoic-tpu for NVIDIA Hopper.

It sits beside the JAX package ``zoic_tpu``, keeps its module names, and
imports neither jax nor ``zoic_tpu``.  Quick start, on the card unless the
caller asks for the CPU::

    import torch
    import zoic_tpu_torch as zt

    cfg = zt.CameraConfig(
        lens_model=zt.LensModel.RAYTRACED,
        lens_data_path=zt.data.lens_path("double_gauss_f2.0"),
        focal_length=5.0, fstop=2.0, focal_distance=100.0,
    )
    cam = zt.Camera(cfg)                    # compiles the lens on "cuda"
    g = torch.Generator(device="cuda").manual_seed(0)
    rays, stats = cam.create_rays(sx, sy, lensx, lensy, generator=g)
    spec = zt.FrameSpec(2048, 1024, spp=2)  # or whole frames
    rays, stats = zt.render.render_rays(cam.state, cfg, spec, generator=g)
    image = zt.render.weight_image(spec, rays)    # [H, W] falloff
    cam.log_stats()

The functional core is ``compile_camera`` and ``create_rays``; the thin-lens
model (pinhole, depth of field, empirical vignetting, image bokeh) runs the
same way with ``lens_model=zt.LensModel.THINLENS``.  ``zt.io.state`` saves
and loads states in the JAX package's v7 format and caches compiles on
disk; ``zt.parallel.sharding`` splits a batch over several cards.

On CUDA tensors the per-ray work runs in the hand-written kernels
``csrc/raytraced.cu``, ``csrc/thinlens.cu`` and ``csrc/bokeh.cu``, built
with ``nvcc`` at first use; on CPU tensors in their plain PyTorch versions.
A batch of any shape (``[B]`` or ``[H, W]``) takes that path;
``impl="jnp"`` in the config runs the exact eager path instead: tensor
ops, differentiable, the kernels' readable reference.  ``python -m zoic_tpu_torch.bench`` times the benchmark's
cameras and ``python -m zoic_tpu_torch.tools.roofline`` the card's op
rates (``csrc/roofline.cu``).
"""

from . import (bokeh, data, interop, io, lensfile, optics, parallel, pupil,
               render, sampling, solve, trace)
from .camera import Camera, compile_camera, create_rays
from .config import CameraConfig, DebugOptions, LensModel
from .io.state import load as load_state
from .render import FrameSpec
from .system import (BokehImage, CameraState, LensSystem, PupilLUT,
                     PupilProfile, RayBatch, RayStats)

__version__ = "0.1.0"

__all__ = [
    "BokehImage",
    "Camera",
    "CameraConfig",
    "CameraState",
    "DebugOptions",
    "FrameSpec",
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
    "interop",
    "io",
    "lensfile",
    "load_state",
    "optics",
    "parallel",
    "pupil",
    "render",
    "sampling",
    "solve",
    "trace",
    "__version__",
]
