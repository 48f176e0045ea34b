"""The port's examples (``zoic_tpu_torch.examples``) against the JAX
package's ``examples/``.

The port compiles (LUT at 5,000 samples, pre-check off: the CPU compile
with it takes seconds) and the JAX package reads that state through its
own loader; the draws are JAX's (``PRNGKey(0)`` for the spot bundle as the
JAX example draws it, others handed in as ``tape_uniforms`` and
``coverage_uniforms``).  The JAX side runs its host and eager code, never
its interpret-mode kernels.  Gates:

* ``spot_rms`` equals the JAX example's own (loaded by path; it needs
  optax) at the designed and the perturbed curvatures within 1e-5
  relative, the JAX side op by op (``jax.disable_jit``, XLA's ``rsqrt``,
  ``cos``, ``sin`` as the port defines them): against XLA's own
  ``rsqrt`` the designed lens's spot, focused to 0.0139 cm, parts by
  8.7e-5, the cancellation in the hit points;
* five ``torch.optim.Adam`` steps give the losses of ``optax.adam(2e-3)``
  on the jitted JAX gradient within 1e-4 relative (measured 2.5e-6: the
  two round their updates in different orders);
* ``render_demo.run`` on the CPU at a 32 x 16 x 2 frame writes the dump
  and the ``.npy`` where matplotlib is missing; its tape equals the JAX
  package's ``raytraced_tape`` (op by op) under ``tape.segment_errors``'
  tolerances, its weight image ``render.weight_image`` of ``create_rays``
  on the frame's samples, its coverage the JAX package's at the 25 film
  points on the same uniforms;
* ``RayStats.vignetted_percent``, the share the demo prints, equals the
  JAX package's on the same counters;
* both examples run on ``"cuda"`` unless asked for the CPU.
"""

import importlib.util
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zoic_tpu as zt
from zoic_tpu import render as jrender
from zoic_tpu import system as jsystem
from zoic_tpu.diag import pupilplot as jpupil
from zoic_tpu.diag import tape as jtape
from zoic_tpu.io import state as jax_state_io

import zoic_tpu_torch as zpt
from zoic_tpu_torch.diag import tape
from zoic_tpu_torch.examples import lens_optimization as lo
from zoic_tpu_torch.examples import render_demo as rd
from _torch_threads import one_thread  # noqa: F401
from test_torch_trace_pupil import _f64_trig, op_by_op  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPOT_RTOL = 1e-5
ADAM_RTOL = 1e-4
ADAM_STEPS = 5
N_LUT = 5000
SPEC = zpt.FrameSpec(32, 16, spp=2)
N_COVERAGE = 500
TAPE_ATOL = 1e-5
TAPE_EXIT_RTOL = 1e-5


def _bridge(state, path):
    """The port's state as the JAX package reads it."""
    zpt.io.state.save(path, state)
    return jax_state_io.load(path)


@pytest.fixture(scope="module")
def jex():
    """The JAX example, loaded from ``examples/`` by path."""
    pytest.importorskip("optax")
    spec = importlib.util.spec_from_file_location(
        "jax_lens_optimization",
        os.path.join(REPO, "examples", "lens_optimization.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tessar(tmp_path_factory):
    state = zpt.compile_camera(lo.config().replace(pupil_precheck=False),
                               "cpu")
    path = str(tmp_path_factory.mktemp("tessar") / "tessar.npz")
    return state.lens, _bridge(state, path).lens


@pytest.fixture(scope="module")
def bundle():
    """The JAX example's on-axis uniforms, ``PRNGKey(0)``, ``[2, 4096]``."""
    return np.asarray(jax.random.uniform(
        jax.random.PRNGKey(0), (2, lo.N_SAMPLES), dtype=jnp.float32))


@pytest.mark.parametrize("which", ["designed", "perturbed"])
def test_spot_rms_matches_jax_example(which, jex, tessar, bundle, op_by_op):
    lens, jlens = tessar
    if which == "designed":
        c, jc = lens.curvature, jlens.curvature
    else:
        # the JAX example's perturbation, lens_optimization.py:70
        c, jc = lo.perturbed(lens), jlens.curvature.at[2].multiply(1.08)
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    got = float(lo.spot_rms(lens, c, torch.from_numpy(bundle.copy())))
    want = float(jex.spot_rms(jlens, jc))
    assert got == pytest.approx(want, rel=SPOT_RTOL, abs=0)


def test_adam_steps_match_optax(jex, tessar, bundle):
    import optax

    lens, jlens = tessar
    _, losses = lo.optimize(lens, lo.perturbed(lens),
                            torch.from_numpy(bundle.copy()), ADAM_STEPS)
    loss_grad = jax.jit(jax.value_and_grad(
        lambda c: jex.spot_rms(jlens, c)))
    opt = optax.adam(lo.LEARNING_RATE)
    c = jlens.curvature.at[2].multiply(1.08)
    opt_state = opt.init(c)
    want = []
    for _ in range(ADAM_STEPS):
        loss, g = loss_grad(c)
        updates, opt_state = opt.update(g, opt_state)
        c = optax.apply_updates(c, updates)
        want.append(float(loss))
    assert len(losses) == ADAM_STEPS
    np.testing.assert_allclose(losses, want, rtol=ADAM_RTOL, atol=0)
    assert losses[-1] < losses[0]


def test_render_demo_matches_jax(tmp_path, monkeypatch):
    """The demo as a card machine without matplotlib runs it: the dump and
    the ``.npy``, no PNG; every number it computed against the JAX
    package on the same state and uniforms."""
    monkeypatch.setattr(zpt.diag.session, "can_render", lambda: False)
    name = rd.DEFAULT_LENS
    u_tape = np.asarray(jax.random.uniform(
        jax.random.PRNGKey(1), (4, rd.TAPE_SAMPLES), dtype=jnp.float32))
    keys = [jax.random.PRNGKey(100 + i) for i in range(len(rd.film_points()))]
    u_cov = [np.asarray(jax.random.uniform(k, (2, N_COVERAGE))) for k in keys]
    res = rd.run(name, str(tmp_path), "cpu", spec=SPEC,
                 lut_bounds_samples=N_LUT, pupil_precheck=False,
                 tape_uniforms=u_tape, coverage_uniforms=u_cov)
    stem = os.path.join(str(tmp_path), name)
    assert res.written == [stem + "_vignetting.npy", stem + ".zoic"]
    assert res.not_drawn == [stem + s for s in
                             ("_vignetting.png", "_diagram.png", "_pupil.png")]
    assert all(os.path.getsize(p) > 0 for p in res.written)
    assert not any(os.path.exists(p) for p in res.not_drawn)
    np.testing.assert_array_equal(np.load(stem + "_vignetting.npy"),
                                  res.image.numpy())
    assert zpt.diag.dump.parse_file(res.dump_path)["RAYS"].size == (
        res.segments.size)

    # the frame: render_rays' samples and seed, from a generator seeded 0
    st, cfg = res.camera.state, res.camera.config
    assert res.image.shape == (SPEC.height, SPEC.width)
    g = torch.Generator().manual_seed(0)
    rays, _ = zpt.create_rays(st, cfg, *zpt.render.frame_samples(SPEC, g),
                              generator=g)
    want_img = zpt.render.weight_image(SPEC, rays)
    assert torch.equal(res.image, want_img)
    np.testing.assert_allclose(
        res.image.numpy(),
        np.asarray(jrender.weight_image(SPEC, types.SimpleNamespace(
            weight=jnp.asarray(rays.weight.numpy())))), rtol=0, atol=1e-7)
    assert 0.0 < float(res.image.mean()) <= 1.0

    js = _bridge(st, str(tmp_path / "state.npz"))
    jcfg = zt.CameraConfig(
        lens_model=zt.LensModel.RAYTRACED,
        lens_data_path=zt.data.lens_path(name), focal_length=5.0,
        fstop=zt.data.LENSES[name].fstop, focal_distance=100.0,
        lut_bounds_samples=N_LUT, pupil_precheck=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.lax, "rsqrt", lambda x: 1.0 / jnp.sqrt(x))
        mp.setattr(jnp, "cos", _f64_trig(np.cos))
        mp.setattr(jnp, "sin", _f64_trig(np.sin))
        with jax.disable_jit():
            u = jnp.asarray(u_tape)
            want_segs = jtape.raytraced_tape(
                js, jcfg, u[0] * 2 - 1, u[1] * 2 - 1, u[2], u[3],
                stride=rd.TAPE_STRIDE)
            want_cov = [jpupil.coverage(js.lens, p, k, N_COVERAGE)
                        for p, k in zip(rd.film_points(), keys)]
    hit_err, exit_rel = tape.segment_errors(res.segments,
                                            np.asarray(want_segs))
    assert hit_err <= TAPE_ATOL and exit_rel <= TAPE_EXIT_RTOL
    assert list(res.coverage) == rd.film_points()
    assert list(res.coverage.values()) == want_cov


@pytest.mark.parametrize("success,vignetted", [(0, 0), (7, 3),
                                                (98_303, 1), (0, 5)])
def test_vignetted_percent_matches_jax(success, vignetted):
    """The demo's printed share, ``RayStats.vignetted_percent``, against the
    JAX package's on the same int32 counters."""
    counts = (success, vignetted, 0, 0)
    got = zpt.RayStats(*(torch.tensor(c, dtype=torch.int32) for c in counts))
    want = jsystem.RayStats(*(jnp.int32(c) for c in counts))
    assert got.vignetted_percent().dtype == torch.float32
    assert float(got.vignetted_percent()) == float(want.vignetted_percent())


def test_examples_run_on_the_card_by_default(monkeypatch):
    """Both entry points, as functions and from the command line, ask for
    ``"cuda"`` unless given ``--device cpu``."""
    import inspect

    for fn in (rd.run, lo.run):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    seen = []
    monkeypatch.setattr(rd, "run", lambda lens, out, device: seen.append(
        (lens, out, device)))
    rd.main([])
    rd.main(["tessar_f2.8", "--out", "x", "--device", "cpu"])
    assert seen == [(rd.DEFAULT_LENS, "out", "cuda"),
                    ("tessar_f2.8", "x", "cpu")]
    stub = lo.Result(1.0, 2.0, [2.0], torch.zeros(1), 1.0)
    monkeypatch.setattr(lo, "run", lambda device: seen.append(device) or stub)
    lo.main([])
    assert seen[-1] == "cuda"
