"""The port's raytraced kernel module against the JAX package's.

On the CPU the port runs its plain PyTorch version
(``zoic_tpu_torch.ops.trace_kernel.raytraced_plain``); the JAX side runs
the Pallas kernel in interpret mode, as ``tests/test_compaction.py`` does.
Gates:

* the counter hash is bit-equal to ``_hash_uniform`` (it decides every
  retry draw); ``_concentric``, ``_pack_elements`` and ``_shaping_table``
  are bit-equal to the JAX functions run op by op (``jax.disable_jit``:
  under jit XLA contracts fmas and rewrites divisions by constants, which
  moves the last bits);
* on the headline state, ``tries`` and ``tir`` are equal on every ray;
  origins and directions agree to 1e-5 on rays within the budget (the
  oracle gate; the interpret-mode program's fma contraction is the
  difference) and to 1e-3 on all rays (vignetted rays hold the frozen
  partial state of their last failed attempt, as in test_compaction).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zoic_tpu.io import state as jax_state_io
from zoic_tpu.ops import trace_kernel as jtk

import zoic_tpu_torch as zpt
from zoic_tpu_torch.ops import trace_kernel as tk

N = 16 * 128 + 77  # more than one 128-lane tile plus a ragged tail
SEED = 12345


@pytest.fixture(scope="module")
def states():
    path = zpt.data.state_path()
    return jax_state_io.load(path), zpt.load_state(path)


def _inputs(n, seed=7):
    rng = np.random.default_rng(seed)
    sx = rng.uniform(-1, 1, n).astype(np.float32)
    sy = rng.uniform(-1, 1, n).astype(np.float32)
    u1 = rng.uniform(0, 1, n).astype(np.float32)
    u2 = rng.uniform(0, 1, n).astype(np.float32)
    return sx, sy, u1, u2


@pytest.mark.parametrize("salt", [0x11111111, 0x22222222],
                         ids=["u1", "u2"])
@pytest.mark.parametrize("seed", [0, SEED, (1 << 22) - 1])
def test_hash_bit_equal(seed, salt):
    ids = np.arange(1 << 20, dtype=np.int32)
    f = jax.jit(lambda i, s, c: jtk._hash_uniform(i, s, c, salt))
    tids = torch.from_numpy(ids)
    for c in range(26):
        ref = np.asarray(f(ids, jnp.int32(seed),
                           jnp.full(ids.shape, c, jnp.int32)))
        got = tk.hash_uniform(tids, seed, torch.full_like(tids, c), salt)
        np.testing.assert_array_equal(got.numpy(), ref,
                                      err_msg=f"counter {c}")


def test_concentric_bit_equal():
    rng = np.random.default_rng(3)
    u1 = rng.uniform(0, 1, 1 << 18).astype(np.float32)
    u2 = rng.uniform(0, 1, 1 << 18).astype(np.float32)
    # the center, the diagonals' branch switch and the square's edges
    edge = np.array([0.5, 0.0, 1.0, 0.5, 0.25, 0.75, 0.0, 1.0], np.float32)
    u1 = np.concatenate([u1, edge])
    u2 = np.concatenate([u2, edge[::-1].copy()])
    with jax.disable_jit():
        jx, jy = jtk._concentric(jnp.asarray(u1), jnp.asarray(u2))
    tx, ty = tk.concentric(torch.from_numpy(u1), torch.from_numpy(u2))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))


def test_fast_sin_cos_bit_equal():
    x = np.random.default_rng(4).uniform(-np.pi, np.pi, 1 << 16)
    x = x.astype(np.float32)
    with jax.disable_jit():
        js, jc = jtk._fast_sin(jnp.asarray(x)), jtk._fast_cos(jnp.asarray(x))
    tx = torch.from_numpy(x)
    np.testing.assert_array_equal(tk.fast_sin(tx).numpy(), np.asarray(js))
    np.testing.assert_array_equal(tk.fast_cos(tx).numpy(), np.asarray(jc))


def test_host_tables_bit_equal(states):
    js, st = states
    with jax.disable_jit():
        je = np.asarray(jtk._pack_elements(js.lens))
        jshap, jsp = jtk._shaping_table(js.lens, True, True)
    np.testing.assert_array_equal(tk.pack_elements(st.lens).numpy(), je)
    tshap, tsp = tk.shaping_table(st.lens)
    np.testing.assert_array_equal(tshap.numpy(), np.asarray(jshap))
    assert float(tsp) == float(jsp)
    assert tk.pack_elements(st.lens).shape == (11, 8)


@pytest.mark.parametrize("max_tries", [6, 25])
def test_plain_matches_interpret_kernel(states, max_tries):
    js, st = states
    sx, sy, u1, u2 = _inputs(N)
    jo, jd, jt, jtir = (
        np.asarray(a) for a in jtk.raytraced_fused(
            js.lens, *(jnp.asarray(a) for a in (sx, sy, u1, u2)),
            js.sensor_width, jnp.int32(SEED), max_tries=max_tries,
            use_lut=True, use_profile=True, interpret=True,
        )
    )
    before = tk.launches
    to, td, tt, ttir = (
        a.numpy() for a in tk.raytraced_fused(
            st.lens, *(torch.from_numpy(a) for a in (sx, sy, u1, u2)),
            st.sensor_width, SEED, max_tries=max_tries,
        )
    )
    assert tk.launches == before  # CPU tensors: the plain version ran
    assert tt.dtype == np.int32 and ttir.dtype == np.int32
    assert to.shape == (N, 3) and td.shape == (N, 3)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(ttir, jtir)
    live = jt <= max_tries
    np.testing.assert_allclose(to[live], jo[live], rtol=0, atol=1e-5)
    np.testing.assert_allclose(td[live], jd[live], rtol=0, atol=1e-5)
    np.testing.assert_allclose(to, jo, rtol=0, atol=1e-3)
    np.testing.assert_allclose(td, jd, rtol=0, atol=1e-3)
    assert (jt > 0).any()  # retries were exercised
    if max_tries == 6:
        assert (~live).any()  # and budgets exhausted


@pytest.mark.parametrize("case", ["overscan", "dead-keys"])
def test_budget_edges_match_interpret_kernel(states, case):
    """Film points beyond the pre-check's fitted domain (|sx| > 1: the
    bound is switched off there) and a bound that rejects the whole disk
    (the dead-key short-circuit: the ray takes its whole budget without a
    trace and keeps a zero payload)."""
    import dataclasses

    js, st = states
    sx, sy, u1, u2 = _inputs(512, seed=11)
    if case == "overscan":
        sx = (sx * 1.6).astype(np.float32)
    else:
        # q1 = -1 everywhere: no offset passes circle 1
        poly = np.asarray(js.lens.profile.poly).copy()
        poly[1] = 0.0
        poly[1, 0] = -1.0
        js = dataclasses.replace(js, lens=dataclasses.replace(
            js.lens, profile=dataclasses.replace(
                js.lens.profile, poly=jnp.asarray(poly))))
        st = dataclasses.replace(st, lens=dataclasses.replace(
            st.lens, profile=dataclasses.replace(
                st.lens.profile, poly=torch.from_numpy(poly))))
    jo, jd, jt, jtir = (np.asarray(a) for a in jtk.raytraced_fused(
        js.lens, *(jnp.asarray(a) for a in (sx, sy, u1, u2)),
        js.sensor_width, jnp.int32(5), max_tries=4, use_lut=True,
        use_profile=True, interpret=True,
    ))
    to, td, tt, ttir = (a.numpy() for a in tk.raytraced_plain(
        st.lens, *(torch.from_numpy(a) for a in (sx, sy, u1, u2)),
        st.sensor_width, 5, max_tries=4,
    ))
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(ttir, jtir)
    np.testing.assert_allclose(to, jo, rtol=0, atol=1e-3)
    np.testing.assert_allclose(td, jd, rtol=0, atol=1e-3)
    if case == "dead-keys":
        assert (tt == 5).all()
        assert not to.any() and not td.any()
    else:
        assert (tt == 5).any() and (tt < 5).any()


def test_wrapper_refuses_unported_variants(states):
    """Named for the refusals of the first slice: naive shaping, which the
    wrapper refused then, now runs (on the headline state, under the
    pre-check fitted for LUT candidates) and matches the interpret-mode
    kernel per ray.  What stays refused: a seed outside [0, 2**22), the
    LUT on a state compiled without it, and a presampled pre-check under a
    disk-fitted bound."""
    js, st = states
    sx, sy, u1, u2 = _inputs(512, seed=13)
    jo, jd, jt, jtir = (np.asarray(a) for a in jtk.raytraced_fused(
        js.lens, *(jnp.asarray(a) for a in (sx, sy, u1, u2)),
        js.sensor_width, jnp.int32(3), max_tries=4, use_lut=False,
        use_profile=True, interpret=True, compact=False,
    ))
    to, td, tt, ttir = (a.numpy() for a in tk.raytraced_fused(
        st.lens, *(torch.from_numpy(a) for a in (sx, sy, u1, u2)),
        st.sensor_width, 3, max_tries=4, use_lut=False,
    ))
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(ttir, jtir)
    live = jt <= 4
    assert (jt > 0).any() and live.any()
    np.testing.assert_allclose(to[live], jo[live], rtol=0, atol=1e-5)
    np.testing.assert_allclose(td[live], jd[live], rtol=0, atol=1e-5)

    z = torch.zeros(4)
    with pytest.raises(ValueError, match="seed"):
        tk.raytraced_fused(st.lens, z, z, z, z, st.sensor_width, 1 << 22,
                           max_tries=2)
    naive = zpt.load_state(zpt.data.state_path("raytraced_naive"))
    with pytest.raises(ValueError, match="LUT"):
        tk.raytraced_fused(naive.lens, z, z, z, z, naive.sensor_width, 0,
                           max_tries=2)
    with pytest.raises(ValueError, match="square-domain"):
        tk.raytraced_fused(st.lens, z, z, z, z, st.sensor_width, 0,
                           max_tries=2, presampled=True)


def test_build_digest_covers_shared_headers(tmp_path, monkeypatch):
    """A library is keyed by its source and every shared ``csrc/*.cuh``:
    an edit to a header builds anew."""
    from zoic_tpu_torch.ops import _build

    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    d1 = _build.source_digest("k")
    (tmp_path / "common.cuh").write_text("// v2\n")
    d2 = _build.source_digest("k")
    (tmp_path / "extra.cuh").write_text("// new\n")
    d3 = _build.source_digest("k")
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n// edit\n')
    d4 = _build.source_digest("k")
    assert len({d1, d2, d3, d4}) == 4 and len(d1) == 16
    assert _build.source_digest("k") == d4
