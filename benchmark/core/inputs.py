"""The general traffic generator: everything a run feeds the camera, made
from ``--seed`` and a traffic file's parameters.

A traffic file (``traffic/<name>.json``) gives the frame (``width``,
``height``, ``aa_samples``: Arnold's ``AA_samples``, so ``aa_samples**2``
camera samples a pixel on a jittered stratified grid), the order its
samples reach the camera (``order``: ``raster``, or ``bucket`` with
``bucket_size``), how many distinct frames of samples set-up makes
(``frames``), how the window drives the camera (``mode``, see
:mod:`core.drive`) and, for a focus pull, the focus schedule
(``focus``).  The same seed gives the same inputs; different seeds give
the same sizes, schedule and compiled camera with other samples and
retry seeds.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np
import torch

MASK64 = (1 << 64) - 1
# the port keys its retry draws by a seed in [0, 2**22)
CALL_SEED_BITS = 22


def mix(seed: int, stream: int) -> int:
    """A 63-bit seed for one stream of draws of a run (splitmix64 of the
    run's seed and the stream's number)."""
    z = (seed * 0x9E3779B97F4A7C15 + (stream + 1) * 0xBF58476D1CE4E5B9) & MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & MASK64
    return (z ^ (z >> 31)) >> 1


def call_seed(seed: int, k: int) -> int:
    """The retry seed of call ``k`` of a run: fresh for every call."""
    return mix(seed, 1000 + k) & ((1 << CALL_SEED_BITS) - 1)


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(mix(seed, stream))


def bucket_pixels(width: int, height: int, size: int) -> Tuple[np.ndarray,
                                                              List[int]]:
    """The frame's pixel indices (``y * width + x``) in bucket order:
    buckets of ``size`` x ``size`` pixels in raster order, the pixels of a
    bucket in raster order within it; and the pixel count of each bucket
    (the last row and column of buckets are cut at the frame's edge)."""
    order, sizes = [], []
    for y0 in range(0, height, size):
        ys = np.arange(y0, min(height, y0 + size))
        for x0 in range(0, width, size):
            xs = np.arange(x0, min(width, x0 + size))
            order.append((ys[:, None] * width + xs[None, :]).reshape(-1))
            sizes.append(len(ys) * len(xs))
    return np.concatenate(order), sizes


def pixel_order(traffic: dict) -> Tuple[np.ndarray, List[int]]:
    """The pixel order of a traffic's frames and the pixels of each call
    (one call a frame, or one a bucket)."""
    w, h = traffic["width"], traffic["height"]
    if traffic.get("order", "raster") == "bucket":
        return bucket_pixels(w, h, traffic["bucket_size"])
    return np.arange(w * h), [w * h]


def frame_samples(traffic: dict, pixels: torch.Tensor, g: torch.Generator,
                  device) -> Tuple[torch.Tensor, ...]:
    """One frame's camera samples ``(sx, sy, lensx, lensy)``, float32 on
    ``device``: ``aa_samples**2`` jittered stratified screen samples a
    pixel, in the order of ``pixels``, with ``sx`` in [-1, 1] across the
    width and ``sy`` in [-h/w, h/w] (Arnold's screen window, y up), and
    uniform lens samples in [0, 1)."""
    w, h, aa = traffic["width"], traffic["height"], traffic["aa_samples"]
    s = aa * aa
    n = pixels.shape[0] * s
    idx = torch.arange(n, device=device)
    pix = pixels[idx // s]
    sub = idx % s
    u = torch.rand((4, n), generator=g, device=device, dtype=torch.float32)
    fx = (pix % w).to(torch.float32) + ((sub % aa).to(torch.float32) + u[0]) / aa
    fy = (pix // w).to(torch.float32) + ((sub // aa).to(torch.float32) + u[1]) / aa
    sx = fx / w * 2.0 - 1.0
    sy = (1.0 - fy / h * 2.0) * (h / w)
    return sx, sy, u[2].contiguous(), u[3].contiguous()


def make_frames(traffic: dict, seed: int, device) -> Tuple[list, List[int]]:
    """``traffic["frames"]`` distinct frames of samples and the ray count
    of each call within a frame."""
    order, sizes = pixel_order(traffic)
    pixels = torch.from_numpy(order).to(device)
    g = generator(seed, 1, device)
    frames = [frame_samples(traffic, pixels, g, device)
              for _ in range(traffic["frames"])]
    s = traffic["aa_samples"] ** 2
    return frames, [p * s for p in sizes]


def focus_schedule(traffic: dict) -> List[float]:
    """The focus pull, one focal distance a frame: ``steps`` values
    log-spaced from ``from_cm`` to ``to_cm``, then back, without repeating
    the ends."""
    f = traffic["focus"]
    lo, hi, n = f["from_cm"], f["to_cm"], f["steps"]
    up = [lo * (hi / lo) ** (i / (n - 1)) for i in range(n)]
    return up + up[-2:0:-1]


def compile_uniforms(shapes: Dict[str, tuple], seed: int,
                     device) -> Dict[str, torch.Tensor]:
    """The lens compile's Monte-Carlo draws, by name, on ``device``: what
    a ``torch.Generator`` seeded ``seed`` gives in the order of ``shapes``,
    which is the order the port's compile draws them in (so seed 0 gives a
    default ``Camera``'s draws).  A configuration fixes the seed
    (``compile_seed``) rather than the run: the draws decide the pre-check's
    form by a Monte-Carlo estimate, and with it the kernel a call runs."""
    g = torch.Generator(device=device).manual_seed(seed)
    return {k: torch.rand(v, generator=g, device=device, dtype=torch.float32)
            for k, v in shapes.items()}


def bokeh_disk(n: int) -> np.ndarray:
    """A disk of radius sqrt(0.8) on an ``n`` x ``n`` grid over [-1, 1]^2,
    as ``[n, n, 3]`` float32 (the port's ``data.bokeh_disk``)."""
    yy, xx = np.mgrid[-1:1:n * 1j, -1:1:n * 1j]
    img = ((xx**2 + yy**2) < 0.8).astype(np.float32)
    return np.stack([img, img, img], -1)


def write_image(pixels: np.ndarray, path: str) -> str:
    """Write ``pixels`` as ``.npy`` at ``path`` (the same bytes every run),
    replacing any file there in one rename."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npy"
    np.save(tmp, pixels)
    os.replace(tmp, path)
    return path

