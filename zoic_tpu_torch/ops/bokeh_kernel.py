"""Image-bokeh CDF inversion and the retry planes drawn by it: the CUDA
kernel's wrappers and their plain PyTorch versions.

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
:func:`sample_plain` for CPU tensors.  :func:`planes_fused` draws the
retry planes of raytraced + image bokeh (the counter hash of each plane
cell, then the inversion) in one launch of the same source, and runs
:func:`planes_plain` for an image on the CPU.

The kernel reads the tables packed by :func:`packed_tables`, the per-row
ones in sorted-row order with a row stride of ``w + 1``; it copies them
into a block's shared memory when they fit (:func:`uses_smem`), else
searches them in global memory.  The plane entry reads its own copy,
:func:`plane_tables`: flat CDF tails collapsed, and guide tables after
them that narrow each search to a bracket of the slice of ``[0, 1)`` its
hashed uniform falls in.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import NamedTuple, Tuple

import torch

from ..system import BokehImage
from ..utils.profiling import span
from . import _launch, trace_kernel

Tensor = torch.Tensor

# launches of the CUDA kernel by sample_fused and by planes_fused (plain
# CPU runs not counted), and of those the launches whose tables were
# searched in global memory (too large for a block's shared memory)
launches = 0
plane_launches = 0
global_launches = 0
plane_global_launches = 0

# draws per searchsorted call of sample_plain: bounds its [chunk, w] gather
_PLAIN_CHUNK = 1 << 20

# csrc/bokeh.cu's threads a block (kBlock; the plane entry's kPlaneBlock)
# and draws a thread a step (kDraws)
BLOCK = 512
PLANE_BLOCK = 1024
DRAWS_PER_THREAD = 4


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


def planes_plain(image: BokehImage, n_cells: int, pseed: int, salt1: int,
                 salt2: int) -> Tuple[Tensor, Tensor]:
    """Plain version of the retry planes, on the image's device: cell ``k``
    of ``[n_cells]`` is the draw of ``hash_uniform(k, pseed, 0, salt1)``
    and ``hash_uniform(k, pseed, 0, salt2)`` (ids and seed as uint32)."""
    ids = torch.arange(n_cells, dtype=torch.int64,
                       device=image.cdf_row.device)
    zero = torch.zeros_like(ids)
    pu1 = trace_kernel.hash_uniform(ids, pseed, zero, salt1)
    pu2 = trace_kernel.hash_uniform(ids, pseed, zero, salt2)
    return sample_plain(image, pu1, pu2)


def table_floats(h: int, w: int) -> int:
    """Floats of the packed tables of an ``h x w`` image: ``cdf_row``,
    ``dy_srow``, and the two per-row tables at row stride ``w + 1``, padded
    to a multiple of 4 (the kernel copies them as float4)."""
    return -(-2 * h * (w + 2) // 4) * 4


def plane_slices(h: int, w: int) -> Tuple[int, int]:
    """``(log2 kr, log2 kc)`` of the plane entry's guides: ``kr`` slices of
    ``[0, 1)`` for the row CDF, 8x the next power of two of ``h`` and at
    least 4,096, and ``kc`` for each sorted row's CDF, the next power of
    two of ``w`` and at least 4; at most ``2**24``, where ``u * K`` stays
    exact."""
    return (min(24, max(12, (8 * h - 1).bit_length())),
            min(24, max(2, (w - 1).bit_length())))


def plane_table_floats(h: int, w: int) -> int:
    """Floats of the plane entry's tables: :func:`table_floats`, then one
    guide word a slice, ``kr`` for the rows and ``kc`` for each of the
    ``h`` sorted rows (:func:`plane_slices`)."""
    log2_kr, log2_kc = plane_slices(h, w)
    return table_floats(h, w) + (1 << log2_kr) + (h << log2_kc)


def smem_bytes(h: int, w: int, planes: bool = False) -> int:
    """Shared memory a block of the kernel takes for an ``h x w`` image
    when the tables go there: 33,792 bytes for 64x64, 133,120 for
    128x128; for the plane entry (``planes``) 66,560 and 215,040."""
    return 4 * (plane_table_floats(h, w) if planes else table_floats(h, w))


def uses_smem(h: int, w: int, limit: int, planes: bool = False) -> bool:
    """Whether the kernel searches an ``h x w`` image's tables in shared
    memory: they fit in ``limit`` bytes, the card's opt-in limit a block
    (232,448 on an H100).  Larger images are searched in global memory."""
    return smem_bytes(h, w, planes) <= limit


def packed_tables(image: BokehImage) -> Tensor:
    """The kernel's tables of ``image``, on its device, as one float32
    tensor of :func:`table_floats` entries (layout in
    :func:`table_views`).  Rows are only moved, never computed, so every
    entry is one of the image's."""
    h, w = image.height, image.width
    if h < 1 or w < 1:
        raise ValueError(f"empty bokeh image ({h}x{w})")
    shapes = {"cdf_row": (h,), "row_indices": (h,), "cdf_col": (h, w),
              "dx_col": (h, w), "dy_srow": (h,)}
    for name, shape in shapes.items():
        if tuple(getattr(image, name).shape) != shape:
            raise ValueError(f"bokeh table {name} has shape "
                             f"{tuple(getattr(image, name).shape)}, expected "
                             f"{shape}")
    f32 = torch.float32
    order = image.row_indices.long()

    def by_row(t):
        rows = t.to(f32)[order]
        return torch.cat([rows, rows.new_zeros(h, 1)], dim=1).reshape(-1)

    parts = [image.cdf_row.to(f32), image.dy_srow.to(f32),
             by_row(image.cdf_col), by_row(image.dx_col)]
    pad = table_floats(h, w) - 2 * h * (w + 2)
    return torch.cat(parts + [parts[0].new_zeros(pad)])


def table_views(packed: Tensor, h: int,
                w: int) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """``(cdf_row [h], dy_srow [h], cdf_col_s [h, w+1], dx_col_s
    [h, w+1])``, views of :func:`packed_tables`: row ``r`` of the last two
    is image row ``row_indices[r]``, its column ``w`` a zero pad."""
    ws = w + 1
    return (packed[:h], packed[h:2 * h],
            packed[2 * h:2 * h + h * ws].view(h, ws),
            packed[2 * h + h * ws:2 * h * (ws + 1)].view(h, ws))


class PlaneTables(NamedTuple):
    """The plane entry's tables (:func:`plane_tables`): ``words``, float32
    [:func:`plane_table_floats`], and the kernel's arguments for them."""

    words: Tensor
    log2_kr: int
    log2_kc: int
    steps_r: int  # the row search's steps: its widest bracket < 2**steps_r
    steps_c: int


def guide_brackets(cdf: Tensor, n_end: Tensor,
                   log2_k: int) -> Tuple[Tensor, Tensor]:
    """``(lo, hi)``, int64 ``[rows, K]``, of ascending ``cdf`` ``[rows, n]``
    whose row ``i`` ends at ``n_end[i]`` entries: the answer
    ``min(upper_bound(cdf[i, :n_end[i]], u), n_end[i] - 1)`` at ``u = k /
    K`` and at ``(k + 1) / K``, by the kernel's f32 compare (``k / K`` is
    exact in f32 for ``K <= 2**24``).  The answer is monotone in ``u``, so
    for every ``u`` of slice ``k``, ``[k / K, (k + 1) / K)``, it lies in
    ``[lo[k], hi[k]]``."""
    k = 1 << log2_k
    u = (torch.arange(k + 1, dtype=torch.float64) / k).to(torch.float32)
    at = torch.minimum(
        torch.searchsorted(cdf.contiguous(),
                           u.expand(cdf.shape[0], k + 1).contiguous(),
                           right=True),
        (n_end.to(torch.int64) - 1)[:, None])
    return at[:, :-1], at[:, 1:]


def plane_tables(image: BokehImage) -> PlaneTables:
    """The plane entry's tables of ``image``, on the CPU: its
    :func:`packed_tables` with each flat CDF tail collapsed, then the guide
    words (layout in ``csrc/bokeh.cu``).

    A tail of equal entries from index ``e`` on (rows and pixels of zero
    luminance sort last) leaves two answers: ``e`` for a draw below its
    value, and ``n - 1`` for one at or above it (``upper_bound`` passes the
    whole tail and is clamped).  So what ``n - 1`` selects (a sorted row's
    tables and ``dy``; a column's ``dx``) is copied to ``e + 1`` and the
    CDF ends there: no bracket spans more than two entries of a tail.  Word
    ``k`` of a CDF is ``lo << s | (hi - lo)`` of :func:`guide_brackets`,
    ``s`` the bit length of that table's widest bracket."""
    h, w = image.height, image.width
    packed = packed_tables(image).cpu()
    cdf_row, dy_srow, cdf_col, dx_col = table_views(packed, h, w)
    last = min(h, int((cdf_row < cdf_row[-1]).sum()) + 2) - 1
    if last < h - 1:
        for t in (dy_srow, cdf_col, dx_col):
            t[last] = t[h - 1]
    cols = cdf_col[:, :w].contiguous()
    n_col = torch.clamp_max((cols < cols[:, -1:]).sum(1) + 2, w)
    dx_col[torch.arange(h), n_col - 1] = dx_col[:, w - 1].clone()
    log2_kr, log2_kc = plane_slices(h, w)
    words, steps = [packed.view(torch.int32)], []
    for cdf, n_end, log2_k in ((cdf_row[None], torch.tensor([last + 1]),
                                log2_kr), (cols, n_col, log2_kc)):
        lo, hi = guide_brackets(cdf, n_end, log2_k)
        s = int((hi - lo).max()).bit_length()
        word = (lo << s | (hi - lo)).reshape(-1)
        if int(word.max()) >> 32:
            raise ValueError(f"bokeh image {h}x{w}: a guide bracket of "
                             f"{2**s - 1} entries does not pack in 32 bits")
        words.append(torch.where(word >> 31 != 0, word - (1 << 32),
                                 word).to(torch.int32))
        steps.append(s)
    return PlaneTables(torch.cat(words).view(torch.float32), log2_kr,
                       log2_kc, *steps)


def persistent_grid(n: int, sm_count: int, blocks_per_sm: int,
                    block: int = BLOCK) -> int:
    """Blocks of ``block`` threads of the kernel's persistent grid for
    ``n`` draws: as many as the card holds at once, but no more than give
    each thread one step of four draws, and at least one."""
    steps = -(-n // DRAWS_PER_THREAD)
    return max(1, min(sm_count * blocks_per_sm, -(-steps // block)))


# (id(image), device, planes) -> (weakref(image), packed tables or
# PlaneTables on the device): made once per image, not once per call
_TABLES: dict = {}
# device index -> opt-in shared memory a block
_CARD: dict = {}


def _kernel_tables(image: BokehImage, dev, planes: bool):
    key = (id(image), str(dev), planes)
    hit = _TABLES.get(key)
    if hit is not None and hit[0]() is image:
        return hit[1]
    with span("zoic.tables.build"):
        if planes:
            t = plane_tables(image)
            tables = t._replace(words=t.words.to(dev).contiguous())
        else:
            tables = packed_tables(image).to(dev).contiguous()
        for k in [k for k, v in _TABLES.items() if v[0]() is None]:
            del _TABLES[k]
        _TABLES[key] = (weakref.ref(image), tables)
        return tables


def _plan(image: BokehImage, n: int, hash_: bool, dev):
    """``(tables, shared, grid)`` of a launch over ``n`` draws: the packed
    tables, or with ``hash_`` the plane entry's :class:`PlaneTables`, whose
    grid takes one block an SM when the tables are in shared memory (every
    block copies them in)."""
    tables = _kernel_tables(image, dev, hash_)
    packed = tables.words if hash_ else tables
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    limit = _CARD.get(index)
    if limit is None:
        with span("zoic.kernel.load"), torch.cuda.device(index):
            limit = _launch.bind("bokeh", "zoic_bokeh_smem_limit", [])()
        if limit < 0:
            raise RuntimeError("bokeh kernel: shared-memory limit query failed")
        _CARD[index] = limit
    shared = uses_smem(image.height, image.width, limit, hash_)
    smem = 4 * packed.numel() if shared else 0
    sms, per_sm = _launch.blocks_per_sm(
        "bokeh", "zoic_bokeh_blocks_per_sm", [ctypes.c_int] * 3, dev,
        int(shared), int(hash_), smem)
    if hash_:
        return tables, shared, persistent_grid(
            n, sms, 1 if shared else per_sm, PLANE_BLOCK)
    return tables, shared, persistent_grid(n, sms, per_sm)


_SAMPLE_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                    + [ctypes.c_void_p])
_PLANES_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int]
                    + [ctypes.c_uint32] * 3 + [ctypes.c_int] * 9
                    + [ctypes.c_void_p])


def sample_fused(image: BokehImage, u_row: Tensor,
                 u_col: Tensor) -> Tuple[Tensor, Tensor]:
    """Bokeh CDF inversion over flat ``[B]`` uniforms: returns
    ``(dx[B], dy[B])`` f32.  CUDA tensors launch ``csrc/bokeh.cu``, for
    every image size :func:`zoic_tpu_torch.bokeh.build` makes; CPU tensors
    run :func:`sample_plain`."""
    global launches, global_launches
    with span("zoic.bokeh.sample"):
        if u_row.device.type == "cpu":
            return sample_plain(image, u_row, u_col)
        if u_row.device.type != "cuda":
            raise ValueError(f"unsupported device {u_row.device}")
        b, dev = _launch.check_flat((("u_row", u_row), ("u_col", u_col)))
        dx, dy = _launch.empty(dev, ((b,), torch.float32),
                               ((b,), torch.float32))
        if b == 0:
            return dx, dy
        packed, shared, grid = _plan(image, b, False, dev)
        _launch.launch(
            _launch.bind("bokeh", "zoic_bokeh_launch", _SAMPLE_ARGTYPES),
            "bokeh", dev, u_row.data_ptr(), u_col.data_ptr(),
            packed.data_ptr(), dx.data_ptr(), dy.data_ptr(), b, image.height,
            image.width, packed.numel(), int(shared), grid,
        )
        launches += 1
        global_launches += int(not shared)
        return dx, dy


def planes_fused(image: BokehImage, n_cells: int, pseed: int, salt1: int,
                 salt2: int) -> Tuple[Tensor, Tensor]:
    """The retry planes as flat ``(dx[n_cells], dy[n_cells])`` f32, on the
    image's device: cell ``k`` is the draw of ``hash_uniform(k, pseed, 0,
    salt1)`` and ``hash_uniform(k, pseed, 0, salt2)``.  An image on the
    card launches ``csrc/bokeh.cu``'s plane entry, which hashes the cell
    index itself and searches the brackets of :func:`plane_tables`; one on
    the CPU runs :func:`planes_plain`."""
    global plane_launches, plane_global_launches
    with span("zoic.bokeh.planes"):
        dev = image.cdf_row.device
        if dev.type == "cpu":
            return planes_plain(image, n_cells, pseed, salt1, salt2)
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        if not 0 <= n_cells < 1 << 31:
            raise ValueError(f"n_cells {n_cells} outside [0, 2**31)")
        dx, dy = _launch.empty(dev, ((n_cells,), torch.float32),
                               ((n_cells,), torch.float32))
        if n_cells == 0:
            return dx, dy
        t, shared, grid = _plan(image, n_cells, True, dev)
        m = 0xFFFFFFFF
        _launch.launch(
            _launch.bind("bokeh", "zoic_bokeh_planes_launch",
                         _PLANES_ARGTYPES),
            "bokeh planes", dev, t.words.data_ptr(), dx.data_ptr(),
            dy.data_ptr(), n_cells, pseed & m, salt1 & m, salt2 & m,
            image.height, image.width, t.words.numel(), t.log2_kr, t.log2_kc,
            t.steps_r, t.steps_c, int(shared), grid,
        )
        plane_launches += 1
        plane_global_launches += int(not shared)
        return dx, dy
