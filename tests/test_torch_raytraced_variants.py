"""Every variant of the port's raytraced kernel against the JAX package's.

The port runs its plain PyTorch version on the CPU
(``zoic_tpu_torch.ops.trace_kernel.raytraced_plain``); the JAX side runs
the Pallas kernel in interpret mode with its whole-tile retry loop
(``compact=False``; ``tests/test_compaction.py`` holds the compacted loop
equal to it per ray).  Both load the same shipped state
(``zoic_tpu_torch/data``) and take the same numpy inputs.  The variants:
the harmonic bound from the select chain and from its polynomial
(fisheye), the circle bound from the select chain (Petzval, focus 30 cm),
a lens without an iris whose film is mostly dead (telephoto, focus
30 cm), naive first-element shaping with and without the pre-check, no
pre-check, element flags read from the table, and ``max_tries=0``.

Gates:

* ``tries`` and ``tir`` equal on every ray, but for borderline rays,
  at most 1 in 10,000 and each shown to be one: a pre-check or cull
  compare that the last bit decides (the interpret program contracts
  fmas, eager PyTorch does not), so that the plain version at a film
  point at most 4 ulp away gives the JAX result.  The fisheye is allowed
  0.5% of rays besides: its stop is flattened to R = 1e4 cm in a 1 cm
  lens, so the f32 iris hit ``t = tca + thc`` cancels two ~1e4 terms and
  carries ~1e-3 cm of rounding error, which the two programs round
  differently; draws within a few percent of the iris edge are decided by
  that rounding (5 of 2,125 rays here; float64 passes both packages'
  disputed draws).
* origins and directions within 1e-5 on rays within the budget (the
  oracle gate; the interpret program's fma contraction is the
  difference), and within 1e-3 on all rays but those whose frozen state
  is ill-conditioned: a vignetted ray keeps the partial state of its last
  failed attempt, and where that attempt grazes a surface or the iris
  edge, moving its film point by a few ulp moves the state by more than
  1e-3.  Each such ray must be shown so, as above.
"""

import dataclasses

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
MAX_TRIES = 6

# id -> (shipped camera, raytraced_fused flags, lens changes, max_tries,
#        tries/tir mismatches allowed)
VARIANTS = {
    "harmonic-chain": ("raytraced_fisheye", {}, {}, MAX_TRIES, N // 200),
    "harmonic-poly": ("raytraced_fisheye", {}, dict(profile_poly=True),
                      MAX_TRIES, N // 200),
    "circles-chain": ("raytraced_petzval_f1.25_focus30", {}, {}, MAX_TRIES,
                      0),
    "no-iris": ("raytraced_telephoto_f5.0_focus30", {}, {}, MAX_TRIES, 0),
    "naive": ("raytraced_naive", dict(use_lut=False), {}, MAX_TRIES, 0),
    "naive-no-precheck": ("raytraced_naive",
                          dict(use_lut=False, use_profile=False), {},
                          MAX_TRIES, 0),
    "no-precheck": ("headline", dict(use_profile=False), {}, MAX_TRIES, 0),
    "dynamic-flags": ("headline", {}, dict(elem_flags=()), MAX_TRIES, 0),
    "max-tries-0": ("headline", {}, {}, 0, 0),
}


def _inputs(n, seed=7):
    rng = np.random.default_rng(seed)
    sx = rng.uniform(-1, 1, n).astype(np.float32)
    sy = rng.uniform(-1, 1, n).astype(np.float32)
    u1 = rng.uniform(0, 1, n).astype(np.float32)
    u2 = rng.uniform(0, 1, n).astype(np.float32)
    return sx, sy, u1, u2


def _states(camera, lens_kw):
    path = zpt.data.state_path(camera)
    js, st = jax_state_io.load(path), zpt.load_state(path)
    return (dataclasses.replace(js, lens=dataclasses.replace(js.lens,
                                                             **lens_kw)),
            dataclasses.replace(st, lens=dataclasses.replace(st.lens,
                                                             **lens_kw)))


def _nudge(x, k):
    """``x`` moved by ``|k|`` ulp towards the sign of ``k``."""
    for _ in range(abs(k)):
        x = np.nextafter(x, np.float32(np.sign(k) * 10.0))
    return x


def check_parity(ref, plain, sx, max_tries, allowance=0):
    """The gates of the module docstring: ``ref`` is the JAX kernel's
    ``(origin, dir, tries, tir)`` as numpy arrays; ``plain(sx)`` runs the
    port's plain version with film x ``sx`` and the other inputs fixed.
    ``allowance`` counts mismatched rays that need not be shown
    borderline."""
    jo, jd, jt, jtir = ref
    to, td, tt, ttir = plain(sx)
    assert tt.dtype == np.int32 and ttir.dtype == np.int32
    assert to.shape == jo.shape and td.shape == jd.shape
    bad = (tt != jt) | (ttir != jtir)
    same = ~bad
    live = same & (jt <= max_tries)
    assert live.any()
    np.testing.assert_allclose(to[live], jo[live], rtol=0, atol=1e-5)
    np.testing.assert_allclose(td[live], jd[live], rtol=0, atol=1e-5)
    err = np.maximum(np.abs(to - jo).max(1), np.abs(td - jd).max(1))
    far = same & (err > 1e-3)
    assert (jt[far] > max_tries).all()  # only vignetted rays
    if bad.any() or far.any():
        shown_t = np.zeros_like(bad)
        shown_p = np.zeros_like(bad)
        for k in (1, -1, 2, -2, 3, -3, 4, -4):
            qo, qd, qt, qtir = plain(_nudge(sx, k))
            qerr = np.maximum(np.abs(qo - jo).max(1), np.abs(qd - jd).max(1))
            agree = (qt == jt) & (qtir == jtir)
            shown_t |= agree
            shown_p |= agree & (qerr <= 1e-3)
        assert int((bad & ~shown_t).sum()) <= allowance, np.nonzero(
            bad & ~shown_t)[0][:20]
        assert int(bad.sum()) <= allowance + max(1, len(jt) // 10_000)
        assert shown_p[far].all(), np.nonzero(far & ~shown_p)[0]
    return tt


@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_matches_interpret_kernel(name):
    camera, flags, lens_kw, max_tries, allowance = VARIANTS[name]
    js, st = _states(camera, lens_kw)
    sx, sy, u1, u2 = _inputs(N)
    use_lut = flags.get("use_lut", True)
    use_profile = flags.get("use_profile", True)
    ref = tuple(np.asarray(a) for a in jtk.raytraced_fused(
        js.lens, *(jnp.asarray(a) for a in (sx, sy, u1, u2)),
        js.sensor_width, jnp.int32(SEED), max_tries=max_tries,
        use_lut=use_lut, use_profile=use_profile, interpret=True,
        compact=False,
    ))

    def plain(x):
        before = tk.launches
        out = tk.raytraced_fused(
            st.lens, *(torch.from_numpy(a) for a in (x, sy, u1, u2)),
            st.sensor_width, SEED, max_tries=max_tries, **flags)
        assert tk.launches == before  # CPU tensors: the plain version ran
        return tuple(a.numpy() for a in out)

    tries = check_parity(ref, plain, sx, max_tries, allowance)
    assert (tries > 0).any()  # retries were exercised
    assert (tries > max_tries).any()  # and budgets exhausted


def test_variants_reach_their_paths():
    """The shipped states hold the variants the parity cases name."""
    fish = zpt.load_state(zpt.data.state_path("raytraced_fisheye")).lens
    assert fish.profile.kind == "harmonic" and not fish.profile_poly
    assert fish.profile.poly is not None and fish.dead_frac >= 0.5
    petz = zpt.load_state(
        zpt.data.state_path("raytraced_petzval_f1.25_focus30")).lens
    assert petz.profile.kind == "circles" and not petz.profile_poly
    tele = zpt.load_state(
        zpt.data.state_path("raytraced_telephoto_f5.0_focus30")).lens
    assert tele.aperture_element == -1 and not tele.iris_identity
    naive = zpt.load_state(zpt.data.state_path("raytraced_naive")).lens
    assert naive.lut is None and naive.profile is not None
    v = tk.variant(fish, True, True, False)
    assert (v.use_lut, v.use_profile, v.use_poly, v.circles) == (
        True, True, False, False)
    assert tk.variant(tele, True, True, False).iris_idx == -1
    flat = dataclasses.replace(naive, elem_flags=())
    assert tk.variant(flat, False, False, False).flags == ()
