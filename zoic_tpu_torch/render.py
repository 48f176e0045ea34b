"""Image-space sample generation and whole-frame ray generation.

Port of ``zoic_tpu/render.py``.  The reference is driven by a renderer's
sampler, which hands ``camera_create_ray`` per-AA-sample screen and lens
coordinates bucket by bucket; this module builds a whole frame's
(screen-UV, lens-UV) samples on the device and maps them to rays in one
call.  Screen convention: ``sx, sy`` span [-1, 1] with ``sy`` flipped so
that image row 0 is the top; samples are in raster order, pixel-major and
sample-minor.

Draws come from a ``torch.Generator`` in place of the JAX package's key,
in this order: the jitter offsets, the lens uniforms, then the retry seed
(:func:`zoic_tpu_torch.create_rays`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .camera import create_rays
from .config import CameraConfig
from .optics import div
from .system import CameraState, RayBatch, RayStats

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class FrameSpec:
    """Frame geometry: resolution and AA samples per pixel."""

    width: int
    height: int
    spp: int = 1

    @property
    def n_samples(self) -> int:
        return self.width * self.height * self.spp


def frame_samples(
    spec: FrameSpec,
    generator: Optional[torch.Generator] = None,
    jitter: bool = True,
    device="cuda",
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """``[W * H * spp]`` samples ``(sx, sy, lensu, lensv)`` in raster order
    on the generator's device (``device`` and a generator seeded 0 when
    none is given).  ``jitter`` offsets each sample uniformly inside its
    pixel; otherwise samples sit at pixel centres."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    dev = generator.device
    n = spec.n_samples
    pix = torch.arange(n, dtype=torch.int32, device=dev) // spec.spp
    px = (pix % spec.width).to(torch.float32)
    py = (pix // spec.width).to(torch.float32)
    if jitter:
        off = torch.rand((2, n), generator=generator, dtype=torch.float32,
                         device=dev)
    else:
        off = torch.full((2, n), 0.5, dtype=torch.float32, device=dev)
    # true division by the frame size, as the JAX package divides
    sx = div(px + off[0], spec.width) * 2.0 - 1.0
    sy = -(div(py + off[1], spec.height) * 2.0 - 1.0)
    lens = torch.rand((2, n), generator=generator, dtype=torch.float32,
                      device=dev)
    return sx, sy, lens[0], lens[1]


def render_rays(
    state: CameraState,
    config: CameraConfig,
    spec: FrameSpec,
    generator: Optional[torch.Generator] = None,
    jitter: bool = True,
) -> Tuple[RayBatch, RayStats]:
    """Whole-frame ray generation: :func:`create_rays` on every AA sample
    of every pixel, on the state's device, all draws from ``generator`` (a
    generator there seeded 0 when none is given)."""
    if generator is None:
        generator = torch.Generator(device=state.device).manual_seed(0)
    sx, sy, lu, lv = frame_samples(spec, generator, jitter)
    return create_rays(state, config, sx, sy, lu, lv, generator=generator)


def weight_image(spec: FrameSpec, rays: RayBatch) -> Tensor:
    """Mean ray weight per pixel as an ``[H, W]`` image: the vignetting
    falloff, the picture the reference's users judge the camera by."""
    return rays.weight.reshape(spec.height, spec.width, spec.spp).mean(-1)
