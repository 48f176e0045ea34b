"""Image-based bokeh aperture sampling by two-level CDF inversion.

Counterpart of ``zoic_tpu/bokeh.py`` (the reference's ``imageData`` class,
src/zoic.cpp:115-486).  :func:`build` runs on the host in NumPy and is a
copy of the JAX package's, so its tables are bit-equal to it, including the
reference's centring quirks that mix width and height
(``row - (width-1)/2`` and ``col - (height-1)/2``, zoic.cpp:441, 466) and
the final [-1, 1] offsets precomputed with true f32 division.

:func:`sample` maps uniform pairs to aperture offsets: on CUDA tensors it
launches the hand-written kernel (:func:`ops.bokeh_kernel.sample_fused`),
on CPU tensors its plain PyTorch version (``sample_plain``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .ops import bokeh_kernel
from .system import BokehImage

Tensor = torch.Tensor


def luminance(pixels: np.ndarray) -> np.ndarray:
    """Per-pixel luminance with the reference's channel fallbacks
    (zoic.cpp:238-245): grayscale uses channel 0 thrice, 2-channel images
    use ch1 for both G and B."""
    if pixels.ndim == 2:
        pixels = pixels[:, :, None]
    c = pixels.shape[2]
    o1 = 1 if c >= 2 else 0
    o2 = 2 if c >= 3 else o1
    p = pixels.astype(np.float32)
    return (p[:, :, 0] * np.float32(0.3) + p[:, :, o1] * np.float32(0.59)
            + p[:, :, o2] * np.float32(0.11))


def build(pixels: np.ndarray, trace=None) -> BokehImage:
    """Sampler tables from an ``[h, w, c]`` float image
    (``bokehProbability``, zoic.cpp:222-417), as CPU tensors.

    ``trace``: optional ``write()`` target receiving every build
    intermediate, the runtime form of the reference's
    ``_DEBUGIMAGESAMPLING`` dump (zoic.cpp:47-51, 248-409)."""
    lum = luminance(np.asarray(pixels))
    h, w = lum.shape

    def emit(label, arr, keys=None):
        if trace is None:
            return
        arr = np.asarray(arr).reshape(-1)
        ks = np.asarray(keys).reshape(-1) if keys is not None else range(len(arr))
        for k, v in zip(ks, arr):
            trace.write(f"{label} [{k}]: {v:.9g}\n")
        trace.write("-" * 46 + "\n")

    total = lum.sum(dtype=np.float64)
    if total <= 0:
        raise ValueError("bokeh image has zero total luminance")
    emit("Pixel Luminance", lum)
    normalized = (lum / np.float32(total)).astype(np.float32)
    emit("Normalized Pixel Value", normalized)

    row_sums = normalized.sum(axis=1, dtype=np.float32)
    emit("Summed Values row", row_sums)
    # descending row sums; ties keep first-index-first (stable sort)
    row_indices = np.argsort(-row_sums, kind="stable").astype(np.int32)
    cdf_row = np.cumsum(row_sums[row_indices], dtype=np.float32)
    # keyed by the sorted row's original index (zoic.cpp:338)
    emit("CDF row", cdf_row, keys=row_indices)

    with np.errstate(divide="ignore", invalid="ignore"):
        per_row = np.where(
            (normalized != 0) & (row_sums[:, None] != 0),
            normalized / row_sums[:, None],
            0.0,
        ).astype(np.float32)

    # columnIndices hold global pixel indices, sorted descending within
    # each row (zoic.cpp:376-382)
    emit("Normalized Pixel value per row", per_row)
    order = np.argsort(-per_row, axis=1, kind="stable").astype(np.int32)
    col_indices = order + (np.arange(h, dtype=np.int32) * w)[:, None]
    sorted_vals = np.take_along_axis(per_row, order, axis=1)
    cdf_col = np.cumsum(sorted_vals, axis=1, dtype=np.float32)
    # keyed by the global pixel index of each sorted column (zoic.cpp:405)
    emit("CDF column", cdf_col, keys=col_indices)

    # the final [-1, 1] remaps (zoic.cpp:441-485) with NumPy's true f32
    # division: width recentres the row pick, height the column pick
    rel_local = col_indices - (np.arange(h, dtype=np.int32) * w)[:, None]
    dx_col = (
        (rel_local - (h - 1) // 2).astype(np.float32)
        / np.float32(w) * np.float32(2.0)
    )
    dy_srow = (
        (row_indices - (w - 1) // 2).astype(np.float32)
        * np.float32(-1.0) / np.float32(h) * np.float32(2.0)
    )

    return BokehImage(
        cdf_row=torch.from_numpy(cdf_row),
        row_indices=torch.from_numpy(row_indices),
        cdf_col=torch.from_numpy(cdf_col),
        col_indices=torch.from_numpy(col_indices),
        dx_col=torch.from_numpy(dx_col),
        dy_srow=torch.from_numpy(dy_srow),
        width=int(w),
        height=int(h),
    )


def load(path: str, trace=None) -> BokehImage:
    """Load a bokeh image file (``imageData::read``, zoic.cpp:168-219):
    ``.npy`` arrays always, other image formats when Pillow is importable.
    ``trace`` forwards to :func:`build`."""
    if path.endswith(".npy"):
        return build(np.load(path), trace=trace)
    try:
        from PIL import Image  # type: ignore
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(
            f"Cannot read {path!r}: install Pillow or provide a .npy array"
        ) from e
    img = np.asarray(Image.open(path), dtype=np.float32) / 255.0
    return build(img, trace=trace)


def sample(image: BokehImage, u_row: Tensor,
           u_col: Tensor) -> Tuple[Tensor, Tensor]:
    """Batched ``bokehSample`` (zoic.cpp:420-485): uniform pairs in [0, 1)
    to [-1, 1]^2 aperture offsets distributed as the image.  Strided inputs
    are copied once here: the kernel reads its inputs in place."""
    return bokeh_kernel.sample_fused(image, u_row.contiguous(),
                                     u_col.contiguous())
