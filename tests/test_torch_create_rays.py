"""The port's main path end to end against the JAX package's.

``zoic_tpu.create_rays`` (fused kernel, interpret mode on the CPU) and
``zoic_tpu_torch.create_rays`` (plain PyTorch version on the CPU) on the
same state, samples and seed: the seed is the JAX path's own draw
``jax.random.randint(key, (), 0, 1 << 22)`` (``models/raytraced.py``),
handed to the port as an int.  The JAX side runs once, at exposure 0;
the other exposures take its weight through the JAX package's own
``apply_exposure`` (nothing else depends on the exposure).  The whole
RayBatch and all four RayStats must match: weights and counters exactly,
origins, directions and the fake derivatives to 1e-5 on rays within the
budget and to 1e-3 on all.
The configurations the first slice refused (image bokeh, naive shaping,
no pre-check, the harmonic bound, the select chain) run on their shipped
states and match as well, image bokeh by distribution.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zoic_tpu as zt
from zoic_tpu.io import state as jax_state_io
from zoic_tpu.models import common as jcommon

import zoic_tpu_torch as zpt
from zoic_tpu_torch.models import common

N = 16 * 128 + 77


def _cfgs(**kw):
    common_kw = dict(
        lens_data_path=zt.data.lens_path("double_gauss_f2.0"),
        focal_length=5.0, fstop=2.0, focal_distance=100.0,
    )
    common_kw.update(kw)
    return (
        zt.CameraConfig(lens_model=zt.LensModel.RAYTRACED, impl="pallas",
                        **common_kw),
        zpt.CameraConfig(lens_model=zpt.LensModel.RAYTRACED, **common_kw),
    )


@pytest.fixture(scope="module")
def states():
    path = zpt.data.state_path()
    return jax_state_io.load(path), zpt.load_state(path, device="cpu")


def _samples(n, seed=21):
    rng = np.random.default_rng(seed)
    return [
        rng.uniform(-1, 1, n).astype(np.float32),
        rng.uniform(-1, 1, n).astype(np.float32),
        rng.uniform(0, 1, n).astype(np.float32),
        rng.uniform(0, 1, n).astype(np.float32),
    ]


@pytest.fixture(scope="module")
def jax_reference(states):
    """``zoic_tpu.create_rays`` on the headline at exposure 0, run once for
    the module (interpret mode costs most of the file's time): ``(samples,
    seed, rays, stats)``.  Of its outputs only the weight depends on the
    exposure, through the JAX package's ``apply_exposure`` at the end."""
    js, _ = states
    js = dataclasses.replace(js, exposure_control=jnp.float32(0.0))
    jcfg, _ = _cfgs()
    s = _samples(N)
    key = jax.random.PRNGKey(42)
    jr, jstats = zt.create_rays(js, jcfg, *(jnp.asarray(a) for a in s),
                                key)
    seed = int(jax.random.randint(key, (), 0, 1 << 22))
    return s, seed, jr, jstats


@pytest.mark.parametrize("exposure", [0.0, 0.5, -0.5])
def test_create_rays_matches_jax(states, jax_reference, exposure):
    _, st = states
    st = dataclasses.replace(
        st, exposure_control=torch.tensor(exposure, dtype=torch.float32))
    _, tcfg = _cfgs()
    s, seed, jr, jstats = jax_reference
    # the JAX package's weight at this exposure: its own exposure step on
    # the exposure-0 reference's weight (which is the unexposed 0 / 1)
    jweight = np.asarray(jcommon.apply_exposure(jr.weight,
                                                jnp.float32(exposure)))
    tr, tstats = zpt.create_rays(st, tcfg, *(torch.from_numpy(a) for a in s),
                                 seed=seed)

    for f in ("success", "vignetted", "tir", "tries_total"):
        got, ref = getattr(tstats, f), getattr(jstats, f)
        assert got.dtype == torch.int32, f
        assert int(got) == int(ref), f
    np.testing.assert_array_equal(tr.weight.numpy(), jweight)
    live = jweight > 0
    for f in ("origin", "dir", "d_ody", "d_ddy"):
        got, ref = getattr(tr, f).numpy(), np.asarray(getattr(jr, f))
        assert got.shape == ref.shape == (N, 3), f
        np.testing.assert_allclose(got[live], ref[live], rtol=0, atol=1e-5,
                                   err_msg=f)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3, err_msg=f)
    # exposure scales the weight of every live ray
    expect = {0.0: 1.0, 0.5: np.float32(1.25), -0.5: np.float32(1 / 1.25)}
    np.testing.assert_allclose(tr.weight.numpy()[live], expect[exposure],
                               rtol=1e-7)
    assert int(tstats.tries_total) > 0  # retries happened


def test_generator_seed_is_deterministic(states):
    _, st = states
    _, tcfg = _cfgs()
    s = [torch.from_numpy(a) for a in _samples(300, seed=5)]
    out = []
    for _ in range(2):
        g = torch.Generator().manual_seed(9)
        out.append(zpt.create_rays(st, tcfg, *s, generator=g))
    np.testing.assert_array_equal(out[0][0].origin.numpy(),
                                  out[1][0].origin.numpy())
    assert int(out[0][1].tries_total) == int(out[1][1].tries_total)
    with pytest.raises(ValueError, match="seed or a torch.Generator"):
        zpt.create_rays(st, tcfg, *s)


def test_weight_quirk_26th_success_is_vignetted():
    """weight is 0 iff tries > max_tries: a ray whose last retry
    succeeded still leaves the loop with tries == max_tries + 1."""
    tries = torch.tensor([0, 1, 25, 26], dtype=torch.int32)
    weight, n_ok, n_vig = common.weight_and_stats(tries, 25)
    np.testing.assert_array_equal(weight.numpy(), [1.0, 1.0, 1.0, 0.0])
    assert n_ok.dtype == torch.int32 and int(n_ok) == 3 and int(n_vig) == 1
    o = torch.ones(4, 3)
    d_o, d_d = common.fake_derivatives(tries, o, 2 * o)
    np.testing.assert_array_equal(d_o[:, 0].numpy(), [0, 1, 1, 1])
    np.testing.assert_array_equal(d_d[:, 0].numpy(), [0, 2, 2, 2])


# configurations the port refused with NotImplementedError before every
# variant of the raytraced kernel was ported: (shipped camera, config
# changes, tries/tir mismatches allowed)
FORMERLY_REFUSED = {
    "use_image": ("raytraced_bokeh_image", {}, 0),
    "naive": ("raytraced_naive", {}, 0),
    "no-precheck": ("headline", dict(pupil_precheck=False), 0),
    # the fisheye's flattened stop: see test_torch_raytraced_variants
    "harmonic": ("raytraced_fisheye", {}, N // 200),
    "select-chain": ("raytraced_petzval_f1.25_focus30", {}, 0),
}


@pytest.mark.parametrize("case", list(FORMERLY_REFUSED))
def test_out_of_slice_configs_raise(case):
    """Named for what these configurations did while the raytraced
    variants were unported: each now runs through the port's
    ``create_rays`` and matches ``zoic_tpu.create_rays`` (its compacted
    retry machine, interpret mode) at max_tries 6.

    With hash draws a ray's draws are keyed by its own try count, so the
    results match per ray: weights and the four counters equal (but for
    the fisheye's allowance), live payloads within 1e-5.  With image bokeh
    the compacted machine assigns retry draws by its fold schedule, so
    retried rays are held by distribution (``tests/test_compaction.py``):
    rays both sides accept at attempt 0 agree within 1e-5, and vignetted
    counts and try totals agree within Monte-Carlo noise."""
    camera, changes, allowance = FORMERLY_REFUSED[case]
    cam = zpt.data.CAMERAS[camera]
    kw = dict(cam.config_kwargs(), max_tries=6, **changes)
    if cam.use_image:
        kw["bokeh_path"] = "disk64.npy"  # the state holds the image
    jcfg = zt.CameraConfig(lens_model=zt.LensModel.RAYTRACED, impl="pallas",
                           lens_data_path=zt.data.lens_path(cam.lens), **kw)
    tcfg = zpt.CameraConfig(lens_model=zpt.LensModel.RAYTRACED,
                            lens_data_path=cam.lens, **kw)
    path = zpt.data.state_path(camera)
    js, st = jax_state_io.load(path), zpt.load_state(path, device="cpu")
    s = _samples(N, seed=33)
    key = jax.random.PRNGKey(7)
    jr, jstats = zt.create_rays(js, jcfg, *(jnp.asarray(a) for a in s), key)
    seed = int(jax.random.randint(key, (), 0, 1 << 22))
    tr, tstats = zpt.create_rays(st, tcfg, *(torch.from_numpy(a) for a in s),
                                 seed=seed)

    jw, tw = np.asarray(jr.weight), tr.weight.numpy()
    for f in ("origin", "dir", "d_ody", "d_ddy"):
        got = getattr(tr, f).numpy()
        assert got.shape == (N, 3) and np.isfinite(got).all(), f
    assert int(tstats.success) + int(tstats.vignetted) == N
    live = (jw > 0) & (tw > 0)
    norm = np.linalg.norm(tr.dir.numpy()[tw > 0], axis=-1)
    np.testing.assert_allclose(norm, 1.0, atol=1e-4)
    if cam.use_image:
        def first(rays):  # accepted at attempt 0: no fake derivative
            return ~np.asarray(rays.d_ody).any(axis=1)

        live &= first(jr) & first(tr)
        assert live.mean() > 0.3
        allowance = 0
        for f in ("vignetted", "tries_total"):
            vj, vt = int(getattr(jstats, f)), int(getattr(tstats, f))
            assert abs(vj - vt) < max(30, 0.15 * (vj + vt + 20)), f
        assert int(tstats.tries_total) > 0
    else:
        assert int((jw != tw).sum()) <= allowance
        for f in ("success", "vignetted", "tir", "tries_total"):
            got, ref = int(getattr(tstats, f)), int(getattr(jstats, f))
            assert abs(got - ref) <= allowance * (kw["max_tries"] + 1
                                                  if f == "tries_total" else 1), f
    err = np.zeros(N)
    for f in ("origin", "dir", "d_ody", "d_ddy"):
        got, ref = getattr(tr, f).numpy(), np.asarray(getattr(jr, f))
        err = np.maximum(err, np.abs(got - ref).max(axis=1))
    assert int((live & (err > 1e-5)).sum()) <= allowance
