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


IMAGES = {
    "disk64": lambda: _disk(64),
    "zero-rows-40x36": lambda: _random(40, 36, 5, zero_every=3),
    "1x1": lambda: _random(1, 1, 1),
    "1x64": lambda: _random(1, 64, 2),
    "64x1": lambda: _random(64, 1, 3, zero_every=5),
    "128x128": lambda: _disk(128),
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


def _fixed_step_upper_bound(a, off, n, u):
    """``csrc/bokeh.cu:upper_bound4`` over flat ``a``: ceil(log2 n)
    halvings of ``base`` with no branch, then one probe."""
    base = off.clone()
    length = n
    while length > 1:
        half = length >> 1
        base = base + torch.where(a[base + half] <= u, half, 0)
        length -= half
    return base - off + (a[base] <= u).long()


def _kernel_search(packed, h, w, u1, u2):
    """The kernel's indexing of the packed tables, in PyTorch."""
    ws = w + 1
    zero = torch.zeros_like(u1, dtype=torch.int64)
    r = torch.clamp_max(_fixed_step_upper_bound(packed, zero, h, u1), h - 1)
    off = 2 * h + r * ws
    c = torch.clamp_max(_fixed_step_upper_bound(packed, off, w, u2), w - 1)
    return packed[off + h * ws + c], packed[h + r]


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
    assert (int(re.search(r"kDraws = (\d+);", src).group(1))
            == tbk.DRAWS_PER_THREAD)
