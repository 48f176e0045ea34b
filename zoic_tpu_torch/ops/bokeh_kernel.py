"""Image-bokeh CDF inversion: the CUDA kernel's wrapper and its plain
PyTorch version.

Port of ``zoic_tpu/ops/bokeh_kernel.py:sample_fused``.  For each draw
``(u1, u2)``:

* ``r = min(upper_bound(cdf_row, u1), h - 1)`` over the ascending row CDF;
* ``src = row_indices[r]``, the image row of sorted row ``r``;
* ``c = min(upper_bound(cdf_col[src], u2), w - 1)`` over that row's CDF;
* ``dx = dx_col[src, c]`` and ``dy = dy_srow[r]``.

Both offsets are selected from tables the host computed with true f32
division, never divided here: a compiler turns ``x / const`` into a
reciprocal multiply that is 1 ulp off.  So the output is bit-equal to
``zoic_tpu.bokeh.sample`` and to the reference's ``std::upper_bound``.

:func:`sample_fused` launches ``csrc/bokeh.cu`` for CUDA tensors and runs
:func:`sample_plain` for CPU tensors.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import Tuple

import torch

from ..system import BokehImage
from . import _launch

Tensor = torch.Tensor

# launches of the CUDA kernel by sample_fused (plain CPU runs not counted)
launches = 0

# draws per searchsorted call of sample_plain: bounds its [chunk, w] gather
_PLAIN_CHUNK = 1 << 20


def sample_plain(image: BokehImage, u_row: Tensor,
                 u_col: Tensor) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version on any device: ``upper_bound`` is
    ``searchsorted(..., right=True)``, the first index whose CDF value
    exceeds the draw."""
    h, w = image.height, image.width
    r = torch.searchsorted(image.cdf_row, u_row, right=True)
    r = torch.clamp_max(r, h - 1)  # past-the-end clamp (zoic.cpp:435)
    src = image.row_indices.long()[r]
    dy = image.dy_srow[r]
    c = torch.empty_like(r)
    for s in range(0, u_row.shape[0], _PLAIN_CHUNK):
        e = s + _PLAIN_CHUNK
        rows = image.cdf_col[src[s:e]]
        c[s:e] = torch.searchsorted(rows, u_col[s:e, None].contiguous(),
                                    right=True)[:, 0]
    c = torch.clamp_max(c, w - 1)  # global-index clamp (zoic.cpp:461)
    dx = image.dx_col[src, c]
    return dx, dy


_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


# (id(image), device) -> (weakref(image), tables): contiguous device copies
# of a compiled image's tables, made once per image, not once per call
_TABLES: dict = {}


def _kernel_tables(image: BokehImage, dev):
    """``(cdf_row, row_indices, cdf_col, dx_col, dy_srow)`` on ``dev``."""
    key = (id(image), str(dev))
    hit = _TABLES.get(key)
    if hit is not None and hit[0]() is image:
        return hit[1]
    h, w = image.height, image.width
    if h < 1 or w < 1:
        raise ValueError(f"empty bokeh image ({h}x{w})")
    shapes = {"cdf_row": (h,), "row_indices": (h,), "cdf_col": (h, w),
              "dx_col": (h, w), "dy_srow": (h,)}
    tables = []
    for name, shape in shapes.items():
        t = getattr(image, name)
        if tuple(t.shape) != shape:
            raise ValueError(f"bokeh table {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        dtype = torch.int32 if name == "row_indices" else torch.float32
        tables.append(t.to(dev, dtype).contiguous())
    tables = tuple(tables)
    for k in [k for k, v in _TABLES.items() if v[0]() is None]:
        del _TABLES[k]
    _TABLES[key] = (weakref.ref(image), tables)
    return tables


def sample_fused(image: BokehImage, u_row: Tensor,
                 u_col: Tensor) -> Tuple[Tensor, Tensor]:
    """Bokeh CDF inversion over flat ``[B]`` uniforms: returns
    ``(dx[B], dy[B])`` f32.  CUDA tensors launch ``csrc/bokeh.cu``, for
    every image size :func:`zoic_tpu_torch.bokeh.build` makes; CPU tensors
    run :func:`sample_plain`."""
    global launches
    if u_row.device.type == "cpu":
        return sample_plain(image, u_row, u_col)
    if u_row.device.type != "cuda":
        raise ValueError(f"unsupported device {u_row.device}")
    b, dev = _launch.check_flat((("u_row", u_row), ("u_col", u_col)))
    cdf_row, row_idx, cdf_col, dx_col, dy_srow = _kernel_tables(image, dev)
    dx, dy = _launch.empty(dev, ((b,), torch.float32), ((b,), torch.float32))
    if b == 0:
        return dx, dy
    _launch.launch(
        _launch.bind("bokeh", "zoic_bokeh_launch", _ARGTYPES), "bokeh", dev,
        u_row.data_ptr(), u_col.data_ptr(), cdf_row.data_ptr(),
        row_idx.data_ptr(), cdf_col.data_ptr(), dx_col.data_ptr(),
        dy_srow.data_ptr(), dx.data_ptr(), dy.data_ptr(),
        b, image.height, image.width,
    )
    launches += 1
    return dx, dy
