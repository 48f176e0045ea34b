"""The port's raytraced image-bokeh (presampled) mode against the JAX
package's.

With image bokeh the attempt-0 offsets and the retry draws are bokeh
offsets; the retry draws come from ``[P, Bp]`` planes, read at the cell
the TPU kernel's whole-tile loop (``compact=False``) gives each ray,
draw index and batch.  Gates:

* ``raytraced_plane_index`` equals the JAX kernel's ``_plane_draws`` cell
  for cell, run in a Pallas kernel in interpret mode, over enough draw
  indices to reach the eight-cycle lane roll, with planes that wrap and
  with grid tiles that share a plane block;
* the port's retry planes (``models.raytraced.retry_planes``) are
  bit-equal to the ones ``zoic_tpu``'s ``_create_rays_pallas`` builds;
* ``raytraced_plain(..., presampled=True)`` against
  ``raytraced_fused(..., presampled=True, compact=False, interpret=True)``
  with and without the square-domain pre-check, and at a batch where
  tiles share plane blocks: ``tries`` and ``tir`` equal on every ray,
  payloads as in ``test_torch_raytraced_variants.check_parity``.

The distribution gates against the compacted ``zoic_tpu.create_rays``
are in ``test_torch_create_rays.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from zoic_tpu import bokeh as jax_bokeh
from zoic_tpu.io import state as jax_state_io
from zoic_tpu.ops import trace_kernel as jtk

import zoic_tpu_torch as zpt
from zoic_tpu_torch.models import raytraced as rt_model
from zoic_tpu_torch.ops import trace_kernel as tk

from test_torch_raytraced_variants import check_parity

SEED = 4242
CAMERA = "raytraced_bokeh_image"


@pytest.fixture(scope="module")
def states():
    path = zpt.data.state_path(CAMERA)
    return jax_state_io.load(path), zpt.load_state(path)


def _jax_plane_cells(n_planes, bp, b, base, count):
    """The flat plane cell ``_plane_draws`` gives each of ``b`` rays for
    draw indices ``base .. base+count-1``, as ``[count, b]`` int64: the
    planes hold their own flat cell index, so a read returns its cell."""
    cells = jnp.arange(n_planes * bp, dtype=jnp.float32).reshape(n_planes, bp)
    rows = -(-b // jtk.LANES)
    tile_rows = jtk.DEF_RT_TILE_ROWS
    while tile_rows >= 32 and rows <= tile_rows // 2:
        tile_rows //= 2
    total_rows = -(-rows // tile_rows) * tile_rows
    grid = total_rows // tile_rows
    (p1, p2), plane_tiles = jtk._prep_retry_planes(cells, cells, tile_rows)
    shared = plane_tiles if plane_tiles < grid else 0

    def kernel(bu1_ref, bu2_ref, out_ref):
        draws = jtk._plane_draws(bu1_ref, bu2_ref, tile_rows, base, count,
                                 shared)
        for j, (u1, _) in enumerate(draws):
            out_ref[j] = u1

    out = pl.pallas_call(
        kernel,
        grid=(grid,),
        in_specs=[pl.BlockSpec((n_planes, tile_rows, jtk.LANES),
                               lambda i: (0, i % plane_tiles, 0))] * 2,
        out_specs=pl.BlockSpec((count, tile_rows, jtk.LANES),
                               lambda i: (0, i, 0)),
        out_shape=jax.ShapeDtypeStruct((count, total_rows, jtk.LANES),
                                       jnp.float32),
        interpret=pltpu.InterpretParams(),
    )(p1, p2)
    return np.asarray(out).reshape(count, -1)[:, :b].astype(np.int64)


@pytest.mark.parametrize(
    "b,bp",
    [(2125, 1000), (32_768, 16_384), (3 * 128 * 128 + 77, 16_384)],
    ids=["wrapped-plane", "two-tiles-one-block", "four-tiles-one-block"],
)
def test_plane_index_matches_plane_draws(b, bp):
    """Draw indices 0..39 reach reuse cycle 9 of 4 planes, so the lane
    roll of cycles 8+ is exercised; the second and third batches share one
    plane block between 2 and 4 grid tiles."""
    n_planes, count = 4, 40
    ref = _jax_plane_cells(n_planes, bp, b, 0, count)
    layout = tk.retry_plane_layout(b, bp, tk.DEF_RT_TILE_ROWS)
    ids = torch.arange(b, dtype=torch.int64)
    for idx in range(count):
        pidx, pos = tk.raytraced_plane_index(ids, idx, n_planes, bp, *layout)
        np.testing.assert_array_equal(pidx * bp + pos.numpy(), ref[idx],
                                      err_msg=f"draw index {idx}")
    assert layout[2] == (bp == 16_384)  # tiles share blocks


def test_retry_planes_match_jax(states):
    """``models.raytraced.retry_planes`` against the plane build of
    ``zoic_tpu/models/raytraced.py:_create_rays_pallas``, bit for bit."""
    js, st = states
    b, max_tries, seed = 70_000, 6, (1 << 22) - 1  # seed + 0x5BD1 > 2**22
    n_planes = min(jtk.BOKEH_PLANES, max_tries + 1)
    bp = min(b, max(1 << 16, b // 8))
    ids = jnp.arange(n_planes * bp, dtype=jnp.int32)
    pseed = jnp.int32(seed) + jnp.int32(0x5BD1)
    zero = jnp.int32(0)
    pu1 = jtk._hash_uniform(ids, pseed, zero, 0x33333333)
    pu2 = jtk._hash_uniform(ids, pseed, zero, 0x44444444)
    j1, j2 = jax_bokeh.sample(js.bokeh, pu1, pu2)
    t1, t2 = rt_model.retry_planes(st, max_tries, b, seed)
    assert t1.shape == (n_planes, bp) == (4, 1 << 16)
    np.testing.assert_array_equal(t1.numpy(), np.asarray(j1).reshape(4, -1))
    np.testing.assert_array_equal(t2.numpy(), np.asarray(j2).reshape(4, -1))


def _bokeh_inputs(st, n, bp, n_planes, seed=5):
    """Film points, attempt-0 bokeh offsets and ``[P, bp]`` bokeh retry
    planes, from numpy uniforms through the port's bokeh sampler (which
    ``test_torch_bokeh.py`` holds bit-equal to the JAX package's)."""
    rng = np.random.default_rng(seed)
    sx, sy = (rng.uniform(-1, 1, n).astype(np.float32) for _ in range(2))
    u = torch.from_numpy(rng.uniform(0, 1, (2, n)).astype(np.float32))
    l1, l2 = (a.numpy() for a in zpt.bokeh.sample(st.bokeh, u[0], u[1]))
    ur = torch.from_numpy(
        rng.uniform(0, 1, (2, n_planes * bp)).astype(np.float32))
    r1, r2 = (a.reshape(n_planes, bp).numpy()
              for a in zpt.bokeh.sample(st.bokeh, ur[0], ur[1]))
    return sx, sy, l1, l2, r1, r2


@pytest.mark.parametrize(
    "use_profile,n,bp,max_tries",
    [(True, 16 * 128 + 77, 2125, 6), (False, 16 * 128 + 77, 2125, 6),
     (True, 32_768, 16_384, 3)],
    ids=["precheck", "no-precheck", "precheck-shared-block"],
)
def test_presampled_plain_matches_whole_tile(states, use_profile, n, bp,
                                             max_tries):
    js, st = states
    assert st.lens.profile_domain == "square"
    sx, sy, l1, l2, r1, r2 = _bokeh_inputs(st, n, bp, 4)
    ref = tuple(np.asarray(a) for a in jtk.raytraced_fused(
        js.lens, *(jnp.asarray(a) for a in (sx, sy, l1, l2)),
        js.sensor_width, jnp.int32(SEED), max_tries=max_tries, use_lut=True,
        use_profile=use_profile, interpret=True, compact=False,
        presampled=True, retry_u1=jnp.asarray(r1), retry_u2=jnp.asarray(r2),
    ))

    def plain(x):
        before = tk.launches
        out = tk.raytraced_fused(
            st.lens, *(torch.from_numpy(a) for a in (x, sy, l1, l2)),
            st.sensor_width, SEED, max_tries=max_tries,
            use_profile=use_profile, presampled=True,
            retry_u1=torch.from_numpy(r1), retry_u2=torch.from_numpy(r2))
        assert tk.launches == before  # CPU tensors: the plain version ran
        return tuple(a.numpy() for a in out)

    tries = check_parity(ref, plain, sx, max_tries)
    assert (tries > 0).any()  # retry draws were read from the planes
    layout = tk.retry_plane_layout(n, bp, tk.DEF_RT_TILE_ROWS)
    assert layout[2] == (n > bp)  # the last case shares plane blocks
