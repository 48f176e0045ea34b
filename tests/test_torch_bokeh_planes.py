"""The host side of ``csrc/bokeh.cu`` and the retry-plane functions, on the
CPU.

* ``packed_tables`` puts the per-row tables in sorted-row order at row
  stride ``w + 1``: its views equal ``cdf_col[row_indices]`` and
  ``dx_col[row_indices]``, and a search over them (``searchsorted``, and
  the kernel's fixed-step search written out in PyTorch) gives
  ``sample_plain``'s offsets and the JAX package's ``bokeh.sample`` bit for
  bit, on the disk, on images with zero rows and on one-row and
  one-column images;
* ``uses_smem`` sends the 64x64 and 128x128 images to shared memory and
  300x200 to global memory at the H100's limit; the persistent grid's size;
* ``planes_plain`` equals the composition it replaced (the counter hash of
  each cell, then the sampler) and JAX's plane draws, with a plane seed
  past ``2**22`` and past ``2**31``, and ``planes_fused`` runs it for an
  image on the CPU without a launch;
* the plane entry's guide tables (``guide_brackets``, ``plane_tables``):
  brackets computed by hand, consecutive brackets sharing their ends, the
  host's step count covering the widest bracket and never exceeding the
  full search's, flat tails collapsed; and its bracketed search written
  out in PyTorch equal, bit for bit, to ``sample_plain``, to the JAX
  package's sampler and to ``planes_plain`` on every listed image, at
  every slice edge ``k / K``, the float just below it, 0.0, 1 - 2**-24
  and every CDF entry; its shared-memory size rule and grid;
* the source's block and draws-per-thread constants match the wrapper's.

No Pallas kernel runs here: JAX's side is its jnp sampler and hash.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zoic_tpu import bokeh as jbokeh
from zoic_tpu.ops import trace_kernel as jtk

from zoic_tpu_torch import bokeh as tbokeh
from zoic_tpu_torch.models import raytraced as rt_model
from zoic_tpu_torch.ops import _build
from zoic_tpu_torch.ops import bokeh_kernel as tbk
from zoic_tpu_torch.ops import trace_kernel as tk
from _bokeh_search import decode as _decode
from _bokeh_search import kernel_search as _kernel_search
from _bokeh_search import planes_search as _planes_search

H100_SMEM_LIMIT = 232_448  # opt-in shared memory a block, bytes


def _disk(n=64, r=0.8):
    yy, xx = np.mgrid[-1:1:n * 1j, -1:1:n * 1j]
    img = ((xx**2 + yy**2) < r).astype(np.float32)
    return np.stack([img, img, img], -1)


def _random(h, w, seed, zero_every=0):
    img = np.random.default_rng(seed).random((h, w, 3), dtype=np.float32)
    if zero_every:
        img[::zero_every] = 0.0
    return img


def _spike(n=64):
    img = np.zeros((n, n, 3), np.float32)
    img[20, 30] = 1.0
    return img


IMAGES = {
    "disk64": lambda: _disk(64),
    "zero-rows-40x36": lambda: _random(40, 36, 5, zero_every=3),
    "1x1": lambda: _random(1, 1, 1),
    "1x64": lambda: _random(1, 64, 2),
    "64x1": lambda: _random(64, 1, 3, zero_every=5),
    "128x128": lambda: _disk(128),
    "300x200": lambda: _random(300, 200, 7, zero_every=5),
    "spike64": _spike,
}


def _draws(image, n, seed):
    """Uniforms with every CDF entry, 0.0 and 1 - 2**-24 among them."""
    rng = np.random.default_rng(seed)
    u1 = rng.uniform(0, 1, n).astype(np.float32)
    u2 = rng.uniform(0, 1, n).astype(np.float32)
    edges1 = np.concatenate([image.cdf_row.numpy(),
                             [0.0, 1.0 - 2.0**-24]]).astype(np.float32)
    edges2 = np.concatenate([image.cdf_col.numpy().reshape(-1),
                             [0.0, 1.0 - 2.0**-24]]).astype(np.float32)
    u1[:len(edges1)] = edges1
    u2[-len(edges2):] = edges2
    return torch.from_numpy(u1), torch.from_numpy(u2)


@pytest.mark.parametrize("name", list(IMAGES))
def test_packed_tables_are_sorted_rows_padded(name):
    image = tbokeh.build(IMAGES[name]())
    h, w = image.height, image.width
    packed = tbk.packed_tables(image)
    assert packed.dtype == torch.float32
    assert packed.numel() == tbk.table_floats(h, w) and packed.numel() % 4 == 0
    cdf_row, dy_srow, cdf_col_s, dx_col_s = tbk.table_views(packed, h, w)
    order = image.row_indices.long()
    assert torch.equal(cdf_row, image.cdf_row)
    assert torch.equal(dy_srow, image.dy_srow)
    assert torch.equal(cdf_col_s[:, :w], image.cdf_col[order])
    assert torch.equal(dx_col_s[:, :w], image.dx_col[order])
    assert not cdf_col_s[:, w].any() and not dx_col_s[:, w].any()
    assert not packed[2 * h * (w + 2):].any()


@pytest.mark.parametrize("name", list(IMAGES))
def test_search_over_packed_tables_equals_sample_plain(name):
    pixels = IMAGES[name]()
    image = tbokeh.build(pixels)
    h, w = image.height, image.width
    u1, u2 = _draws(image, 4097 + 2 * h * w, seed=h * w)
    dx_p, dy_p = tbk.sample_plain(image, u1, u2)
    # searchsorted over the sorted-row tables: no row_indices needed
    cdf_row, dy_srow, cdf_col_s, dx_col_s = tbk.table_views(
        tbk.packed_tables(image), h, w)
    r = torch.clamp_max(torch.searchsorted(cdf_row, u1, right=True), h - 1)
    c = torch.searchsorted(cdf_col_s[r, :w], u2[:, None], right=True)[:, 0]
    c = torch.clamp_max(c, w - 1)
    bits = (dx_p.view(torch.int32), dy_p.view(torch.int32))
    for dx, dy in ((dx_col_s[r, c], dy_srow[r]),
                   _kernel_search(tbk.packed_tables(image), h, w, u1, u2)):
        assert torch.equal(dx.view(torch.int32), bits[0])
        assert torch.equal(dy.view(torch.int32), bits[1])
    dx_j, dy_j = jbokeh.sample(jbokeh.build(pixels), jnp.asarray(u1.numpy()),
                               jnp.asarray(u2.numpy()))
    np.testing.assert_array_equal(dx_p.numpy(), np.asarray(dx_j))
    np.testing.assert_array_equal(dy_p.numpy(), np.asarray(dy_j))


@pytest.mark.parametrize("h,w,smem,shared", [
    (64, 64, 33_792, True), (128, 128, 133_120, True),
    (300, 200, 484_800, False), (1, 1, 32, True), (169, 169, 231_200, True),
    (170, 170, 233_920, False),
])
def test_shared_memory_choice_by_size(h, w, smem, shared):
    assert tbk.smem_bytes(h, w) == smem
    assert tbk.uses_smem(h, w, H100_SMEM_LIMIT) is shared


@pytest.mark.parametrize("n,grid", [
    (1, 1), (4, 1), (2048, 1), (2049, 2), (4 * 512 * 396, 396),
    (4_194_304, 396), (2_097_152, 396), (0, 1),
])
def test_persistent_grid(n, grid):
    assert tbk.persistent_grid(n, 132, 3) == grid


def _jax_planes(pixels, n_cells, pseed):
    ids = jnp.arange(n_cells, dtype=jnp.int32)
    seed = jnp.asarray(np.uint32(pseed & 0xFFFFFFFF).view(np.int32))
    zero = jnp.int32(0)
    pu1 = jtk._hash_uniform(ids, seed, zero, rt_model.SALT_P1)
    pu2 = jtk._hash_uniform(ids, seed, zero, rt_model.SALT_P2)
    return jbokeh.sample(jbokeh.build(pixels), pu1, pu2)


@pytest.mark.parametrize("n_cells,pseed", [
    (4, 77 + rt_model.PLANE_SEED_OFFSET),
    (8500, (1 << 22) - 1 + rt_model.PLANE_SEED_OFFSET),
    (67_468, (1 << 31) + 12_345),
])
def test_planes_plain_equals_hash_then_sample(n_cells, pseed):
    pixels = _disk(64)
    image = tbokeh.build(pixels)
    ids = torch.arange(n_cells, dtype=torch.int64)
    zero = torch.zeros_like(ids)
    old = tbokeh.sample(
        image, tk.hash_uniform(ids, pseed, zero, rt_model.SALT_P1),
        tk.hash_uniform(ids, pseed, zero, rt_model.SALT_P2))
    before = tbk.plane_launches
    got = tbk.planes_fused(image, n_cells, pseed, rt_model.SALT_P1,
                           rt_model.SALT_P2)
    assert tbk.plane_launches == before  # an image on the CPU: plain ran
    plain = tbk.planes_plain(image, n_cells, pseed, rt_model.SALT_P1,
                             rt_model.SALT_P2)
    ref = _jax_planes(pixels, n_cells, pseed)
    for g, p, o, j in zip(got, plain, old, ref):
        assert g.shape == (n_cells,) and g.dtype == torch.float32
        assert torch.equal(g, p) and torch.equal(g, o)
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))


@pytest.mark.parametrize("max_tries,b,shape", [
    (25, 4_194_304, (4, 524_288)), (6, 70_000, (4, 65_536)),
    (1, 2125, (2, 2125)), (0, 1, (1, 1)),
])
def test_plane_shape(max_tries, b, shape):
    assert rt_model.plane_shape(max_tries, b) == shape


def test_source_constants_match_the_wrapper():
    with open(os.path.join(_build.CSRC, "bokeh.cu")) as f:
        src = f.read()
    assert int(re.search(r"kBlock = (\d+);", src).group(1)) == tbk.BLOCK
    assert (int(re.search(r"kPlaneBlock = (\d+);", src).group(1))
            == tbk.PLANE_BLOCK)
    assert (int(re.search(r"kDraws = (\d+);", src).group(1))
            == tbk.DRAWS_PER_THREAD)


# ---- the plane entry's guide tables and bracketed search


def _guides(t, h, w):
    """The row guide ``(lo, hi)`` ``[kr]`` and the column guides
    ``[h, kc]`` of :class:`PlaneTables` ``t``."""
    base, kr, kc = tbk.table_floats(h, w), 1 << t.log2_kr, 1 << t.log2_kc
    row = _decode(t.words[base:base + kr], t.steps_r)
    col = _decode(t.words[base + kr:base + kr + h * kc], t.steps_c)
    return row, tuple(x.view(h, kc) for x in col)


def _edges(log2_k):
    """Every slice edge ``k / K`` and the float just below each (above 0)."""
    k = 1 << log2_k
    at = (np.arange(k, dtype=np.float64) / k).astype(np.float32)
    below = np.nextafter(at[1:], np.float32(0))
    return np.concatenate([at, below, [np.float32(1.0 - 2.0**-24)]])


@pytest.mark.parametrize("cdf,n_end,lo,hi", [
    ([0.25, 0.5, 0.5, 0.75, 1.0], 5, [0, 1, 3, 4], [1, 3, 4, 4]),
    ([0.25, 0.5, 0.5, 0.75, 1.0], 3, [0, 1, 2, 2], [1, 2, 2, 2]),
    ([0.1, 0.2, 0.3, 0.4], 4, [0, 2, 3, 3], [2, 3, 3, 3]),
    ([0.0, 0.0, 1.0, 1.0], 4, [2, 2, 2, 2], [2, 2, 2, 3]),
])
def test_guide_brackets_by_hand(cdf, n_end, lo, hi):
    """Four slices: the clamped upper_bound at 0, 1/4, 1/2, 3/4 and 1."""
    got = tbk.guide_brackets(torch.tensor([cdf], dtype=torch.float32),
                             torch.tensor([n_end]), 2)
    assert got[0].tolist() == [lo] and got[1].tolist() == [hi]


@pytest.mark.parametrize("name", list(IMAGES))
def test_guides_bracket_every_answer(name):
    """Guide word ``k`` brackets the answer of every draw of slice ``k``:
    consecutive brackets share their ends, the first starts at the answer
    at 0 and the last ends at the answer at 1, within the CDF (never the
    zero pad); the host's step count is the bit length of the widest
    bracket, so it covers it, and it is no more than the full search's
    ``ceil(log2 n)`` halvings."""
    image = tbokeh.build(IMAGES[name]())
    h, w = image.height, image.width
    t = tbk.plane_tables(image)
    assert t.words.dtype == torch.float32
    assert t.words.numel() == tbk.plane_table_floats(h, w)
    assert (t.log2_kr, t.log2_kc) == tbk.plane_slices(h, w)
    (rlo, rhi), (clo, chi) = _guides(t, h, w)
    for lo, hi, n, steps in ((rlo[None], rhi[None], h, t.steps_r),
                             (clo, chi, w, t.steps_c)):
        assert torch.equal(lo[:, 1:], hi[:, :-1])
        assert int(lo.min()) >= 0 and int(hi.max()) <= n - 1
        width = int((hi - lo).min()), int((hi - lo).max())
        assert width[0] >= 0 and width[1] < 1 << steps
        assert steps == width[1].bit_length()
        assert steps <= (n - 1).bit_length()
    cdf_row, _, cdf_col_s, _ = tbk.table_views(t.words[:tbk.table_floats(
        h, w)], h, w)
    # the answers at 0 and at 1 (the clamp: min(upper_bound, n - 1))
    assert int(rlo[0]) == min(int((cdf_row <= 0).sum()), h - 1)
    assert int(rhi[-1]) <= h - 1


def test_flat_tails_collapse_to_two_entries():
    """The disk's rows end in runs of equal CDF entries (its dark pixels):
    over the image's own column CDFs a bracket spans up to 52 entries, over
    the plane entry's collapsed ones one.  Its dark rows sort last: the
    plane tables' row after the first of them selects what the last row
    selects, its all-zero CDF (every draw past its end, at the clamped
    ``w - 1``) collapsed in turn to the first two columns."""
    image = tbokeh.build(_disk(64))
    h, w = image.height, image.width
    order = image.row_indices.long()
    n_full = torch.full((h,), w)
    lo, hi = tbk.guide_brackets(image.cdf_col[order], n_full,
                                tbk.plane_slices(h, w)[1])
    assert int((hi - lo).max()) == 52
    t = tbk.plane_tables(image)
    assert (t.steps_r, t.steps_c) == (1, 1)
    views = tbk.table_views(t.words[:tbk.table_floats(h, w)], h, w)
    packed = tbk.table_views(tbk.packed_tables(image), h, w)
    e = int((packed[0] < packed[0][-1]).sum())
    assert e < h - 2
    for got, orig in zip(views[1:3], packed[1:3]):  # dy_srow, cdf_col_s
        assert torch.equal(got[:e + 1], orig[:e + 1])
        assert torch.equal(got[e + 1], orig[h - 1])
    assert not views[2][e + 1].any()
    assert views[3][e + 1, 1] == packed[3][h - 1, w - 1]


def _edge_draws(image, t, seed):
    """Row draws: every ``k / K`` of the row guide, the float below each,
    0.0, 1 - 2**-24 and every row CDF entry; column draws the same for the
    column guides and every column CDF entry; both filled to one length
    with uniforms."""
    rng = np.random.default_rng(seed)
    u1 = np.concatenate([_edges(t.log2_kr), image.cdf_row.numpy()])
    u2 = np.concatenate([_edges(t.log2_kc),
                         image.cdf_col.numpy().reshape(-1)])
    n = max(len(u1), len(u2)) + 4099
    fill = [rng.uniform(0, 1, n - len(u)).astype(np.float32)
            for u in (u1, u2)]
    u1, u2 = (np.concatenate([u, f]).astype(np.float32)
              for u, f in zip((u1, u2), fill))
    # 1.0 and above stand for no draw: the hash stays below 1
    u1, u2 = (np.minimum(u, np.float32(1.0 - 2.0**-24)) for u in (u1, u2))
    return torch.from_numpy(u1), torch.from_numpy(rng.permutation(u2))


@pytest.mark.parametrize("name", list(IMAGES))
def test_bracketed_search_equals_sample_plain_and_jax(name):
    pixels = IMAGES[name]()
    image = tbokeh.build(pixels)
    h, w = image.height, image.width
    t = tbk.plane_tables(image)
    u1, u2 = _edge_draws(image, t, seed=h * w + 1)
    dx, dy = _planes_search(t, h, w, u1, u2)
    dx_p, dy_p = tbk.sample_plain(image, u1, u2)
    assert torch.equal(dx.view(torch.int32), dx_p.view(torch.int32))
    assert torch.equal(dy.view(torch.int32), dy_p.view(torch.int32))
    dx_j, dy_j = jbokeh.sample(jbokeh.build(pixels), jnp.asarray(u1.numpy()),
                               jnp.asarray(u2.numpy()))
    np.testing.assert_array_equal(dx.numpy(), np.asarray(dx_j))
    np.testing.assert_array_equal(dy.numpy(), np.asarray(dy_j))


@pytest.mark.parametrize("name", list(IMAGES))
def test_bracketed_search_of_hashed_cells_equals_planes_plain(name):
    """The plane entry's whole computation on the bench's seed and salts:
    each cell's hash, its slices, the bracketed searches."""
    image = tbokeh.build(IMAGES[name]())
    h, w = image.height, image.width
    n_cells, pseed = 70_001, 77 + rt_model.PLANE_SEED_OFFSET
    ids = torch.arange(n_cells, dtype=torch.int64)
    zero = torch.zeros_like(ids)
    u1 = tk.hash_uniform(ids, pseed, zero, rt_model.SALT_P1)
    u2 = tk.hash_uniform(ids, pseed, zero, rt_model.SALT_P2)
    got = _planes_search(tbk.plane_tables(image), h, w, u1, u2)
    want = tbk.planes_plain(image, n_cells, pseed, rt_model.SALT_P1,
                            rt_model.SALT_P2)
    for g, p in zip(got, want):
        assert torch.equal(g.view(torch.int32), p.view(torch.int32))


@pytest.mark.parametrize("h,w,kr,kc,smem,shared", [
    (64, 64, 4096, 64, 66_560, True), (128, 128, 4096, 128, 215_040, True),
    (300, 200, 4096, 256, 808_384, False), (1, 1, 4096, 4, 16_432, True),
    (1, 64, 4096, 64, 17_168, True), (64, 1, 4096, 4, 18_944, True),
    (160, 100, 4096, 128, 228_864, True), (164, 100, 4096, 128, 234_176, False),
    (1024, 8, 8192, 8, 147_456, True),
])
def test_plane_table_size_and_shared_memory(h, w, kr, kc, smem, shared):
    assert tbk.plane_slices(h, w) == (kr.bit_length() - 1,
                                      kc.bit_length() - 1)
    assert tbk.smem_bytes(h, w, planes=True) == smem
    assert tbk.uses_smem(h, w, H100_SMEM_LIMIT, planes=True) is shared


@pytest.mark.parametrize("n,blocks_per_sm,grid", [
    (2_097_152, 1, 132), (4 * 1024 * 132, 1, 132), (4 * 1024, 1, 1),
    (4 * 1024 + 1, 1, 2), (2_097_152, 2, 264), (1, 1, 1),
])
def test_plane_grid(n, blocks_per_sm, grid):
    assert tbk.persistent_grid(n, 132, blocks_per_sm,
                               tbk.PLANE_BLOCK) == grid
