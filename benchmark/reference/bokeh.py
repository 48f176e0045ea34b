"""The plain reference's image bokeh: the sampler tables built on the host
from the image's pixels (``bokehProbability``, zoic.cpp:222-417) and the
two-level CDF inversion (``bokehSample``, zoic.cpp:420-485).

A frozen copy of ``zoic_tpu_torch/bokeh.py:build`` (without its debug dump)
and of ``zoic_tpu_torch/ops/bokeh_kernel.py:sample_plain``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .system import BokehImage

Tensor = torch.Tensor

# draws per searchsorted call: bounds the [chunk, w] gather
_CHUNK = 1 << 20


def luminance(pixels: np.ndarray) -> np.ndarray:
    """Per-pixel luminance with the reference's channel fallbacks
    (zoic.cpp:238-245)."""
    if pixels.ndim == 2:
        pixels = pixels[:, :, None]
    c = pixels.shape[2]
    o1 = 1 if c >= 2 else 0
    o2 = 2 if c >= 3 else o1
    p = pixels.astype(np.float32)
    return (p[:, :, 0] * np.float32(0.3) + p[:, :, o1] * np.float32(0.59)
            + p[:, :, o2] * np.float32(0.11))


def build(pixels: np.ndarray) -> BokehImage:
    """Sampler tables from an ``[h, w, c]`` float image, as CPU tensors."""
    lum = luminance(np.asarray(pixels))
    h, w = lum.shape
    total = lum.sum(dtype=np.float64)
    if total <= 0:
        raise ValueError("bokeh image has zero total luminance")
    normalized = (lum / np.float32(total)).astype(np.float32)
    row_sums = normalized.sum(axis=1, dtype=np.float32)
    row_indices = np.argsort(-row_sums, kind="stable").astype(np.int32)
    cdf_row = np.cumsum(row_sums[row_indices], dtype=np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        per_row = np.where(
            (normalized != 0) & (row_sums[:, None] != 0),
            normalized / row_sums[:, None],
            0.0,
        ).astype(np.float32)
    order = np.argsort(-per_row, axis=1, kind="stable").astype(np.int32)
    col_indices = order + (np.arange(h, dtype=np.int32) * w)[:, None]
    sorted_vals = np.take_along_axis(per_row, order, axis=1)
    cdf_col = np.cumsum(sorted_vals, axis=1, dtype=np.float32)
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


def sample(image: BokehImage, u_row: Tensor,
           u_col: Tensor) -> Tuple[Tensor, Tensor]:
    """``upper_bound`` as ``searchsorted(..., right=True)``: the first
    index whose CDF value exceeds the draw, clamped past the end.  The
    tables are read in the draws' type (the control's lower precision
    reads them rounded)."""
    h, w = image.height, image.width
    cdf_row = image.cdf_row.to(u_row.dtype)
    cdf_col = image.cdf_col.to(u_row.dtype)
    r = torch.searchsorted(cdf_row, u_row.contiguous(), right=True)
    r = torch.clamp_max(r, h - 1)
    src = image.row_indices.long()[r]
    dy = image.dy_srow.to(u_row.dtype)[r]
    c = torch.empty_like(r)
    for s in range(0, u_row.shape[0], _CHUNK):
        e = s + _CHUNK
        rows = cdf_col[src[s:e]]
        c[s:e] = torch.searchsorted(rows, u_col[s:e, None].contiguous(),
                                    right=True)[:, 0]
    c = torch.clamp_max(c, w - 1)
    dx = image.dx_col.to(u_row.dtype)[src, c]
    return dx, dy
