"""The Petzval f/1.25 wide open at focus 1000 cm (the benchmark's
``petzval_f125`` configuration) through the port's ``Camera``, against the
JAX package and against the benchmark's plain reference
(``benchmark/reference``), on the CPU.

All three compile from the lens file with the draws
``zoic_tpu.compile_camera`` makes with its default keys
(``test_torch_compile_camera.jax_uniforms``; fewer LUT samples, for speed,
in all three).  The port's state is the reference's bit for bit, and the
jitted JAX compile's within the gates of ``test_torch_compile_camera.py``;
its pre-check is the shipped state's (circles from the select chain,
kernel instance 11, a dead film of 0.9).  On 2,125 film samples over the
whole frame the three classes of ray this camera makes are present (lit;
dead-key, which the bound rejects outright; live but vignetted after all
its tries).  Every output and counter of ``Camera.create_rays`` equals the
reference's; on the JAX compile's state the port's ``create_rays`` equals
``zoic_tpu.create_rays`` (its compacted retry machine, interpret mode):
weights and the four counters equal, live payloads within 1e-5.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zoic_tpu
import zoic_tpu_torch as zt
from zoic_tpu_torch.ops import trace_kernel as tk
from _torch_threads import one_thread  # noqa: F401
from test_torch_compile_camera import (_assert_same_rays, _compare, bridge,
                                       jax_uniforms)

from benchmark import run
from benchmark.reference import camera as ref_camera
from benchmark.reference import rays as ref_rays

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark", "configs")
N = 16 * 128 + 77
N_LUT = 2000
KEY = 7


def _fields(obj, prefix=""):
    """Every tensor and static field of a state, by dotted name."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            out[prefix + f.name] = v
        elif dataclasses.is_dataclass(v):
            out.update(_fields(v, prefix + f.name + "."))
        elif v is not None:
            out[prefix + f.name] = v
    return out


@pytest.fixture(scope="module")
def petzval():
    """The port's camera, the reference's state and the JAX package's state
    from one lens file and one set of compile draws, and one call of each
    on ``N`` samples."""
    with open(os.path.join(CONFIGS, "petzval_f125.json")) as f:
        config = json.load(f)
    cam = ref_camera.camera_fields({**config["camera"],
                                    "lut_bounds_samples": N_LUT})
    lens_path = os.path.join(CONFIGS, cam.lens_file)
    uniforms = {k: torch.tensor(v)
                for k, v in jax_uniforms(N_LUT).items()}
    camera = zt.Camera(run.camera_config(zt, cam, lens_path, None), "cpu",
                       uniforms=uniforms)
    ref_state = ref_camera.compile_camera(cam, "cpu", lens_path=lens_path,
                                          uniforms=uniforms)
    jcfg = zoic_tpu.CameraConfig(
        lens_model=zoic_tpu.LensModel.RAYTRACED, impl="pallas",
        lens_data_path=zoic_tpu.data.lens_path("petzval_f1.25"),
        **{k: getattr(camera.config, k) for k in (
            "sensor_width", "sensor_height", "focal_length", "fstop",
            "focal_distance", "kolb_sampling_lut", "lut_film_samples",
            "lut_bounds_samples", "max_tries")})
    jstate = zoic_tpu.compile_camera(jcfg)

    u = torch.rand((4, N), generator=torch.Generator().manual_seed(7))
    samples = (u[0] * 2 - 1, (u[1] * 2 - 1) * 0.5625, u[2], u[3])
    key = jax.random.PRNGKey(KEY)
    seed = int(jax.random.randint(key, (), 0, 1 << 22))
    rays, stats = camera.create_rays(*samples, seed=seed)
    ref = ref_rays.create_rays(ref_state, cam, *samples, seed)
    jax_rays = zoic_tpu.create_rays(
        jstate, jcfg, *(jnp.asarray(s.numpy()) for s in samples), key)
    on_jax_state = zt.create_rays(bridge(jstate), camera.config, *samples,
                                  seed=seed)
    return dict(camera=camera, ref_state=ref_state, jstate=jstate,
                samples=samples, seed=seed, rays=rays, stats=stats, ref=ref,
                jax_rays=jax_rays, on_jax_state=on_jax_state)


def test_the_compile_equals_the_references(petzval):
    a, b = _fields(petzval["camera"].state), _fields(petzval["ref_state"])
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def test_the_compile_matches_jax(petzval):
    camera = petzval["camera"]
    ref = bridge(petzval["jstate"])
    _compare(camera.state, ref)
    _assert_same_rays(camera.state, ref, camera.config)


def test_the_precheck_is_the_shipped_states(petzval):
    lens = petzval["camera"].state.lens
    shipped = zt.load_state(zt.data.state_path(
        "petzval_f1.25_fl5_f1.25_fd1000.v7.npz"), "cpu").lens
    for got in (lens, shipped):
        assert got.profile.kind == "circles"
        assert not got.profile_poly
        assert got.dead_frac == pytest.approx(0.9)
        v = tk.variant(got, True, True, False)
        assert tk.variant_word(v, False) == 11


def _counters(stats):
    return [int(v) for v in (stats.success, stats.vignetted, stats.tir,
                             stats.tries_total)]


def test_the_rays_and_counters_equal_the_references(petzval):
    rays, stats, ref = petzval["rays"], petzval["stats"], petzval["ref"]
    samples, seed = petzval["samples"], petzval["seed"]
    for f in ("origin", "dir", "weight", "d_ody", "d_ddy"):
        assert torch.equal(getattr(rays, f), getattr(ref, f)), f
    counters = _counters(stats)
    assert counters == list(ref.counters)
    # the three classes: the bound's dead keys, lit rays, and live rays
    # vignetted after all their tries
    lens = petzval["camera"].state.lens
    v = tk.variant(lens, True, True, False)
    _, table, prof, scal = tk._prepare(
        lens, petzval["camera"].state.sensor_width, seed, N, v)
    s = scal.tolist()
    pcs = tk._shaping(samples[0] * s[6], samples[1] * s[6], table, s[4],
                      prof.tolist(), s[7], v)[4]
    dead = tk._bound_dead(pcs, v.circles)
    lit = rays.weight != 0
    live_vignetted = ~lit & ~dead
    assert not bool((lit & dead).any())
    assert min(int(dead.sum()), int(lit.sum()), int(live_vignetted.sum())) > 0
    assert int(dead.sum()) + int(live_vignetted.sum()) == counters[1]


def test_the_rays_and_counters_equal_jaxs(petzval):
    jr, jstats = petzval["jax_rays"]
    tr, tstats = petzval["on_jax_state"]
    jw, tw = np.asarray(jr.weight), tr.weight.numpy()
    np.testing.assert_array_equal(tw, jw)
    assert _counters(tstats) == _counters(jstats)
    live = tw > 0
    assert 0 < int(live.sum()) < N // 2
    for f in ("origin", "dir", "d_ody", "d_ddy"):
        np.testing.assert_allclose(getattr(tr, f).numpy()[live],
                                   np.asarray(getattr(jr, f))[live],
                                   rtol=0, atol=1e-5, err_msg=f)
