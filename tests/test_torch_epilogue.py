"""The port's epilogue against the JAX package's, on the CPU.

``zoic_tpu_torch.ops.epilogue_kernel.epilogue_fused`` runs its plain
version (``epilogue_plain``) on CPU tensors; the pinhole's mode (no weight
counting) and the thin lens's (no ``tir``), which only the plain version
takes, run ``epilogue_plain`` itself.  The JAX side composes its own
``weight_and_stats``, ``apply_exposure`` and ``fake_derivatives``
(``zoic_tpu/models/common.py``) and the counter sums of its kernel paths,
run eagerly, never an interpret-mode kernel.  Inputs come from numpy with
a seed: tries at 0, 1, 25 and 26 (``max_tries + 1``) and random within
[0, 26], origins and directions with signed zeros among them, exposures
of both signs and 0, B = 0, 1 and ``16*128+77``.  Gates: weights and the four
counters equal, ``dOdy``/``dDdy`` bit-equal.  Each model's kernel path
runs the epilogue once a ``create_rays`` (the raytraced through
``epilogue_fused``, the thin lens in its camera kernel's launch);
``impl="jnp"`` never.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zoic_tpu.models import common as jcommon

import zoic_tpu_torch as zpt
from zoic_tpu_torch.ops import epilogue_kernel as ek
from zoic_tpu_torch.ops import trace_kernel as tk
from _torch_threads import one_thread  # noqa: F401

MAX_TRIES = 25
SIZES = (0, 1, 16 * 128 + 77)
EXPOSURES = (-1.5, -0.5, 0.0, 0.5, 2.0)
COUNTERS = ("success", "vignetted", "tir", "tries_total")


def _inputs(n, seed=17):
    """``(tries i32, tir i32, origin f32 [n,3], direction f32 [n,3])``: the
    first rays take tries 0, 1, 25, 26, the rest random in [0, 26]; a
    tenth of the vector components are signed zeros."""
    rng = np.random.default_rng(seed + n)
    tries = rng.integers(0, MAX_TRIES + 2, n).astype(np.int32)
    edge = np.array([0, 1, MAX_TRIES, MAX_TRIES + 1], np.int32)[:n]
    tries[:edge.size] = edge
    tir = rng.integers(0, 4, n).astype(np.int32)
    vecs = []
    for _ in range(2):
        v = rng.normal(size=(n, 3)).astype(np.float32)
        zeros = rng.uniform(size=(n, 3)) < 0.1
        v[zeros] = np.where(rng.uniform(size=zeros.sum()) < 0.5, 0.0, -0.0)
        vecs.append(v)
    return tries, tir, vecs[0], vecs[1]


def _jax_epilogue(tries, tir, origin, direction, exposure, count_weight):
    """The JAX package's epilogue as its kernel paths compose it
    (``models/raytraced.py:_create_rays_pallas``, and with the pinhole's
    weight 1 and the thin lens's tir 0, ``models/thinlens.py``)."""
    t = jnp.asarray(tries)
    if count_weight:
        weight, n_ok, n_vig = jcommon.weight_and_stats(t, MAX_TRIES)
    else:
        weight, n_ok, n_vig = jnp.ones(t.shape, jnp.float32), 0, 0
    d_ody, d_ddy = jcommon.fake_derivatives(t, jnp.asarray(origin),
                                            jnp.asarray(direction))
    weight = jcommon.apply_exposure(weight, jnp.float32(exposure))
    n_tir = 0 if tir is None else jnp.sum(jnp.asarray(tir), dtype=jnp.int32)
    stats = (n_ok, n_vig, n_tir, jnp.sum(t, dtype=jnp.int32))
    return (np.asarray(weight), np.asarray(d_ody), np.asarray(d_ddy),
            [int(s) for s in stats])


def _bits(a):
    return np.ascontiguousarray(a).view(np.int32)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("with_tir", [True, False], ids=["tir", "no-tir"])
@pytest.mark.parametrize("count_weight", [True, False],
                         ids=["weighted", "pinhole"])
@pytest.mark.parametrize("exposure", EXPOSURES)
def test_epilogue_matches_jax(exposure, count_weight, with_tir, n):
    tries, tir, origin, direction = _inputs(n)
    tir = tir if with_tir else None
    args = (torch.from_numpy(tries),
            None if tir is None else torch.from_numpy(tir),
            torch.from_numpy(origin), torch.from_numpy(direction),
            torch.tensor(exposure, dtype=torch.float32), MAX_TRIES)
    if with_tir and count_weight:
        weight, d_ody, d_ddy, stats = ek.epilogue_fused(*args)
    else:
        weight, d_ody, d_ddy, stats = ek.epilogue_plain(
            *args, count_weight=count_weight)
    jw, jo, jd, jstats = _jax_epilogue(tries, tir, origin, direction,
                                       exposure, count_weight)

    assert weight.dtype == torch.float32 and weight.shape == (n,)
    assert d_ody.shape == d_ddy.shape == (n, 3)
    assert stats.dtype == torch.int32 and stats.shape == (4,)
    np.testing.assert_array_equal(weight.numpy(), jw)
    np.testing.assert_array_equal(_bits(d_ody.numpy()), _bits(jo))
    np.testing.assert_array_equal(_bits(d_ddy.numpy()), _bits(jd))
    assert stats.tolist() == jstats
    if n > 3 and count_weight:
        # the quirk: tries == max_tries is live, max_tries + 1 is not
        assert float(weight[2]) > 0.0 and float(weight[3]) == 0.0


def _thinlens_state(**kw):
    cfg = zpt.CameraConfig(lens_model=zpt.LensModel.THINLENS, focal_length=5.0,
                           fstop=1.4, focal_distance=100.0, max_tries=3, **kw)
    return cfg, zpt.compile_camera(cfg, "cpu")


@pytest.mark.parametrize("model", ["raytraced", "thinlens", "pinhole"])
def test_kernel_path_calls_the_epilogue_once(model, monkeypatch):
    """``create_rays``' kernel path runs the epilogue exactly once, its
    counters as 0-d views of the buffer it returned: the raytraced model
    through ``epilogue_fused``, the thin lens (and its pinhole) inside
    ``trace_kernel.thinlens_rays``, its camera kernel's launch, with no
    ``epilogue_fused`` call; ``impl="jnp"`` composes the plain pieces and
    calls neither."""
    if model == "raytraced":
        cam = zpt.data.CAMERAS["headline"]
        cfg = zpt.CameraConfig(lens_model=zpt.LensModel.RAYTRACED,
                               lens_data_path=cam.lens, max_tries=3,
                               **cam.config_kwargs())
        st = zpt.load_state(zpt.data.state_path(), device="cpu")
    else:
        cfg, st = _thinlens_state(
            use_dof=model == "thinlens", optical_vignetting_distance=4.0,
            optical_vignetting_radius=0.6)
    fused, rays, calls, thin = ek.epilogue_fused, tk.thinlens_rays, [], []

    def counted(*a, **k):
        out = fused(*a, **k)
        calls.append((a[1] is None, True, out[3]))
        return out

    def counted_rays(*a, **k):
        out = rays(*a, **k)
        thin.append((True, k["use_dof"], out[5]))
        return out

    monkeypatch.setattr(ek, "epilogue_fused", counted)
    monkeypatch.setattr(tk, "thinlens_rays", counted_rays)
    rng = np.random.default_rng(3)
    s = [torch.from_numpy(rng.uniform(lo, 1, 300).astype(np.float32))
         for lo in (-1, -1, 0, 0)]
    for impl, n_calls in (("auto", 1), ("jnp", 0)):
        del calls[:], thin[:]
        c = dataclasses.replace(cfg, impl=impl)
        _, stats = zpt.create_rays(st, c, *s, seed=5)
        ran = calls if model == "raytraced" else thin
        assert len(ran) == n_calls and len(calls + thin) == n_calls, impl
        if n_calls:
            no_tir, count_weight, buf = ran[0]
            assert no_tir == (model != "raytraced")
            assert count_weight == (model != "pinhole")
            for i, f in enumerate(COUNTERS):
                got = getattr(stats, f)
                assert got.dim() == 0 and got.data_ptr() == buf[i].data_ptr()
        assert int(stats.success) + int(stats.vignetted) == (
            0 if model == "pinhole" else 300)
