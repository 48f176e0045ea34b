"""The port's diagnostics (``zoic_tpu_torch.diag``) against the JAX package's.

Both packages read the same shipped states; inputs come from numpy with a
seed.  The JAX side runs op by op, as ``tests/test_torch_eager_path.py``
runs it: under ``jax.disable_jit`` with XLA's ``rsqrt`` taken as
``1 / sqrt`` and its float32 ``cos``/``sin`` as the float64 ones rounded,
the port's definitions.  Its results are computed once, in the module
fixture ``ref``.  Gates:

* the hit tape of ``trace.trace_stack``: NaN where JAX has NaN, values
  within 1e-5; ``record_tape=False`` returns no tape and the same bits;
* ``raytraced_tape`` (LUT and naive shaping): the same number of segments
  (no borderline hit among these rays: ``MAX_SEGMENT_DIFF`` is 0), hit
  points within 1e-5 absolute, exit endpoints (x 10,000 extension)
  within 1e-5 relative; ``thinlens_tape`` bit-equal;
* ``dump.lens_header`` byte-equal (headline, fisheye, the iris-less
  telephoto), and each package's parser reads the other's dumps;
* ``ground_truth_pupil``/``lut_samples`` on JAX's own uniforms: the same
  points within 1e-5, ``coverage`` within 1/n;
* the draw session: ``Camera`` with ``debug.draw``, ``finish``, and
  ``session.render_debug_session`` against the JAX package's dump.

Skips: ``test_reference_dump_parses`` unless ``ZOIC_REFERENCE_DRAW_ZOIC``
names the reference plugin's checked-in ``src/draw.zoic`` (it is not in
this repository); the tests that draw a PNG where matplotlib is missing.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zoic_tpu as jt
from zoic_tpu import trace as jtrace
from zoic_tpu.diag import dump as jdump
from zoic_tpu.diag import pupilplot as jpupil
from zoic_tpu.diag import tape as jtape
from zoic_tpu.io import state as jax_state_io
from zoic_tpu.optics import V3 as JV3

import zoic_tpu_torch as zpt
from zoic_tpu_torch.diag import dump, pupilplot, session, tape
from zoic_tpu_torch.optics import V3
from _torch_threads import one_thread  # noqa: F401

ATOL = 1e-5
EXIT_RTOL = 1e-5
MAX_SEGMENT_DIFF = 0
N_TAPE, TAPE_STRIDE = 1024, 4
N_SESSION, SESSION_STRIDE = 256, 32
N_PUPIL = 2_000
FILM_POINTS = ((0.0, 0.0), (0.9, -0.6), (1.8, 1.8))
HEADER_CAMERAS = ("headline", "raytraced_fisheye",
                  "raytraced_telephoto_f5.0_focus100")
# the reference plugin's checked-in src/draw.zoic, where a checkout of the
# reference is at hand
REF_DUMP = os.environ.get("ZOIC_REFERENCE_DRAW_ZOIC", "")


def _f64_trig(fn):
    def f(x):
        if getattr(x, "dtype", None) == jnp.float32:
            return jnp.asarray(fn(np.asarray(x, np.float64)).astype(np.float32))
        return fn(x)
    return f


def _samples(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, n).astype(np.float32),
            rng.uniform(-1, 1, n).astype(np.float32),
            rng.uniform(0, 1, n).astype(np.float32),
            rng.uniform(0, 1, n).astype(np.float32)]


def _cfgs(camera="headline", **kw):
    c = zpt.data.CAMERAS[camera]
    kwargs = dict(c.config_kwargs(), **kw)
    return (jt.CameraConfig(lens_model=jt.LensModel.RAYTRACED,
                            lens_data_path=jt.data.lens_path(c.lens),
                            **kwargs),
            zpt.CameraConfig(lens_model=zpt.LensModel.RAYTRACED,
                             lens_data_path=zpt.data.lens_path(c.lens),
                             **kwargs))


def _trace_inputs(lens, n=512, seed=1):
    """Film points and first-element targets over the whole element."""
    rng = np.random.default_rng(seed)
    ox, oy, px, py = (rng.uniform(-1, 1, n).astype(np.float32)
                      for _ in range(4))
    oz = np.full(n, float(lens.origin_shift), np.float32)
    dz = np.full(n, -float(lens.thickness[0]), np.float32)
    return (ox, oy, oz), (px - ox, py - oy, dz)


@pytest.fixture(scope="module")
def states():
    path = zpt.data.state_path()
    return jax_state_io.load(path), zpt.load_state(path, device="cpu")


@pytest.fixture(scope="module")
def ref(states):
    """Every JAX result the module compares with, computed op by op."""
    js, st = states
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.lax, "rsqrt", lambda x: 1.0 / jnp.sqrt(x))
        mp.setattr(jnp, "cos", _f64_trig(np.cos))
        mp.setattr(jnp, "sin", _f64_trig(np.sin))
        with jax.disable_jit():
            o, d = _trace_inputs(st.lens)
            res = jtrace.trace_stack(
                js.lens, JV3(*map(jnp.asarray, o)), JV3(*map(jnp.asarray, d)),
                record_tape=True)
            out["trace"] = (np.asarray(res.tape_z), np.asarray(res.tape_y))
            for lut in (True, False):
                jcfg, _ = _cfgs(kolb_sampling_lut=lut)
                out["tape", lut] = jtape.raytraced_tape(
                    js, jcfg, *map(jnp.asarray, _samples(N_TAPE, 0)),
                    stride=TAPE_STRIDE)
            jcfg, _ = _cfgs()
            out["session"] = jtape.raytraced_tape(
                js, jcfg, *map(jnp.asarray, _samples(N_SESSION, 2)),
                stride=SESSION_STRIDE)
            for i, fxy in enumerate(FILM_POINTS):
                key = jax.random.PRNGKey(10 + i)
                out["pupil", fxy] = (
                    np.asarray(jax.random.uniform(key, (2, N_PUPIL))),
                    jpupil.ground_truth_pupil(js.lens, fxy, key, N_PUPIL),
                    jpupil.lut_samples(js.lens, fxy, key, N_PUPIL),
                    jpupil.coverage(js.lens, fxy, key, N_PUPIL))
    return out


def _check_segments(got, want):
    """The same segments (``tape.segment_errors`` raises otherwise), hit
    points within ``ATOL`` and exit endpoints within ``EXIT_RTOL``."""
    assert abs(len(got) - len(want)) <= MAX_SEGMENT_DIFF
    assert np.isfinite(got).all()
    assert (np.abs(want[:, 2]) > tape.EXIT_Z).sum() > 0
    hit_err, exit_rel = tape.segment_errors(got, want)
    assert hit_err <= ATOL and exit_rel <= EXIT_RTOL


# ------------------------------------------------------------- the tape

def test_trace_stack_tape_matches_jax(states, ref):
    _, st = states
    o, d = _trace_inputs(st.lens)
    res = zpt.trace.trace_stack(st.lens, V3(*map(torch.from_numpy, o)),
                                V3(*map(torch.from_numpy, d)),
                                record_tape=True)
    assert res.tape_z.shape == (st.lens.count, 512)
    for got, want in zip((res.tape_z, res.tape_y), ref["trace"]):
        got = got.numpy()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        assert np.isfinite(want).sum() > 512
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_trace_stack_without_tape_is_unchanged(states):
    """The tape is recorded beside the trace: the result's other fields
    are the same bits with and without it."""
    _, st = states
    o, d = _trace_inputs(st.lens, n=2_125, seed=4)
    args = (st.lens, V3(*map(torch.from_numpy, o)),
            V3(*map(torch.from_numpy, d)))
    plain = zpt.trace.trace_stack(*args)
    taped = zpt.trace.trace_stack(*args, record_tape=True)
    assert plain.tape_z is None and plain.tape_y is None
    for a, b in zip((*plain.origin, *plain.direction, plain.ok, plain.tir),
                    (*taped.origin, *taped.direction, taped.ok, taped.tir)):
        assert torch.equal(a, b)
    assert 0 < int(plain.ok.sum()) < 2_125


@pytest.mark.parametrize("lut", [True, False], ids=["lut", "naive"])
def test_raytraced_tape_matches_jax(states, ref, lut):
    _, st = states
    _, cfg = _cfgs(kolb_sampling_lut=lut)
    got = tape.raytraced_tape(st, cfg, *map(torch.from_numpy,
                                            _samples(N_TAPE, 0)),
                              stride=TAPE_STRIDE)
    assert got.dtype == np.float32 and got.shape[1] == 4
    _check_segments(got, ref["tape", lut])


def test_segment_errors(states):
    """``segment_errors`` reads hit points absolutely and exit endpoints
    relatively, and refuses tapes of other segments."""
    _, st = states
    _, cfg = _cfgs()
    want = tape.raytraced_tape(st, cfg, *map(torch.from_numpy,
                                             _samples(256, 9)), stride=2)
    assert tape.segment_errors(want, want) == (0.0, 0.0)
    got = want.copy()
    got[0, 1] += 3e-5
    got[-1, 2] *= 1.0 + 2e-5
    hit_err, exit_rel = tape.segment_errors(got, want)
    assert 2e-5 < hit_err < 4e-5 and 1e-5 < exit_rel < 3e-5
    with pytest.raises(ValueError, match="segments"):
        tape.segment_errors(got[1:], want)
    with pytest.raises(ValueError, match="last block"):
        tape.segment_errors(got[::-1], want[::-1])


def test_thinlens_tape_bit_equal():
    rng = np.random.default_rng(5)
    origin = rng.normal(size=(300, 3)).astype(np.float32)
    direction = rng.normal(size=(300, 3)).astype(np.float32)
    want = jtape.thinlens_tape(None, None, None, origin, direction, stride=7)
    got = tape.thinlens_tape(None, None, None, torch.from_numpy(origin),
                             torch.from_numpy(direction), stride=7)
    assert got.shape == (43, 4)
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------- the dumps

@pytest.mark.parametrize("camera", HEADER_CAMERAS)
def test_lens_header_byte_equal(camera):
    path = zpt.data.state_path(camera)
    want = jdump.lens_header(jax_state_io.load(path).lens, 2.4)
    got = dump.lens_header(zpt.load_state(path, device="cpu").lens, 2.4)
    assert got == want
    assert ("APERTUREELEMENT{-1}" in got) == ("telephoto" in camera)


def _writer(kind):
    """``write(module, lens, path)`` for one of the dump writers, on fixed
    data."""
    rng = np.random.default_rng(6)
    segs = rng.normal(scale=50.0, size=(37, 4)).astype(np.float32)
    if kind == "write":
        return lambda mod, lens, p: mod.write(p, lens, segs, 2.4)
    if kind == "write_thinlens":
        return lambda mod, lens, p: mod.write_thinlens(p, segs)
    gt = [rng.normal(size=(k, 2)) for k in (5, 0, 9)]
    ss = [rng.normal(size=(4, 2)) for _ in range(3)]
    return lambda mod, lens, p: mod.write_aperture_test(p, gt, ss)


@pytest.mark.parametrize("kind", ["write", "write_thinlens",
                                  "write_aperture_test"])
def test_dumps_interchange(tmp_path, states, kind):
    """Each package's parser reads the other's file and gets back what
    the other's parser reads from its own; the files are the same bytes."""
    js, st = states
    writer = _writer(kind)
    a, b = str(tmp_path / "port.zoic"), str(tmp_path / "jax.zoic")
    writer(dump, st.lens, a)
    writer(jdump, js.lens, b)
    with open(a) as fa, open(b) as fb:
        assert fa.read() == fb.read()
    if kind == "write_aperture_test":
        got, want = dump.parse_aperture_test(b), jdump.parse_aperture_test(a)
        for g, w in zip(got[0] + got[1], want[0] + want[1]):
            np.testing.assert_array_equal(g, w)
        assert [len(r) for r in got[0]] == [5, 0, 9]
        return
    got, want = dump.parse_file(b), jdump.parse_file(a)
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    assert got["RAYS"].shape == (37, 4)


@pytest.mark.skipif(not os.path.isfile(REF_DUMP),
                    reason="ZOIC_REFERENCE_DRAW_ZOIC names no file")
def test_reference_dump_parses(tmp_path):
    """The reference plugin's own dump: both parsers read the same arrays,
    and the port draws it (``tests/test_diag.py``)."""
    got, want = dump.parse_file(REF_DUMP), jdump.parse_file(REF_DUMP)
    assert got["LENSMODEL"] == "KOLB" and got["RAYS"].shape[1] == 4
    for k in got:
        if k != "LENSMODEL":
            np.testing.assert_array_equal(got[k], want[k])
    pytest.importorskip("matplotlib")
    from zoic_tpu_torch.diag import draw

    out = tmp_path / "ref.png"
    draw.render(got, str(out))
    assert out.stat().st_size > 10_000


# ------------------------------------------------------ the pupil plots

@pytest.mark.parametrize("fxy", FILM_POINTS, ids=["centre", "mid", "corner"])
def test_pupil_points_match_jax(states, ref, fxy):
    _, st = states
    u, gt_want, ss_want, cov_want = ref["pupil", fxy]
    gt = pupilplot.ground_truth_pupil(st.lens, fxy, N_PUPIL, uniforms=u)
    ss = pupilplot.lut_samples(st.lens, fxy, N_PUPIL, uniforms=u)
    assert gt.shape == gt_want.shape and len(gt) > 0
    np.testing.assert_allclose(gt, gt_want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(ss, ss_want, rtol=0, atol=ATOL)
    cov = pupilplot.coverage(st.lens, fxy, N_PUPIL, uniforms=u)
    assert abs(cov - cov_want) <= 1.0 / N_PUPIL


def test_selftest_dump_round_trip(tmp_path, states):
    _, st = states
    p = str(tmp_path / "testApertures.zoic")
    pupilplot.write_selftest_dump(st.lens, p, film_grid=1, n_gt=500,
                                  n_ss=300)
    gt, ss = dump.parse_aperture_test(p)
    assert len(gt) == 9 and len(ss) == 9
    assert all(r.shape == (300, 2) for r in ss)
    # GT rows target the whole first element at 2x diameter over-cover
    # (zoic.cpp:1374-1376): only ~10-15% of probes survive even on-axis
    assert len(gt[4]) > 40
    # the JAX package's parser reads it, and the draws follow the seed
    assert [len(r) for r in jdump.parse_aperture_test(p)[0]] == [
        len(r) for r in gt]
    q = str(tmp_path / "again.zoic")
    pupilplot.write_selftest_dump(st.lens, q, film_grid=1, n_gt=500,
                                  n_ss=300)
    with open(p) as fp, open(q) as fq:
        assert fp.read() == fq.read()


def test_render_comparison(tmp_path, states):
    pytest.importorskip("matplotlib")
    _, st = states
    out = tmp_path / "pupil.png"
    pupilplot.render_comparison(st.lens, str(out), film_grid=1, n_gt=500,
                                n_ss=300)
    assert out.stat().st_size > 10_000


# ------------------------------------------------------ the draw session

def _thinlens_cfg(**debug):
    return zpt.CameraConfig(
        lens_model=zpt.LensModel.THINLENS, focal_length=5.0, fstop=1.4,
        focal_distance=100.0, use_dof=True,
        debug=zpt.DebugOptions(**debug))


def test_camera_draw_thinlens(tmp_path):
    pytest.importorskip("matplotlib")
    cam = zpt.Camera(_thinlens_cfg(draw=True, draw_stride=64), "cpu")
    samples = list(map(torch.from_numpy, _samples(512, 0)))
    rays, _ = cam.create_rays(*samples, seed=0)
    assert len(cam._draw_segments) == 1
    np.testing.assert_array_equal(
        cam._draw_segments[0],
        tape.thinlens_tape(cam.state, None, None, rays.origin, rays.dir, 64))
    png = cam.finish(out_dir=str(tmp_path))
    assert png == str(tmp_path / "lensDrawing.png") and os.path.exists(png)
    d = dump.parse_file(str(tmp_path / "draw.zoic"))
    assert d["LENSMODEL"] == "THINLENS"
    assert len(d["RAYS"]) == 512 // 64


def test_camera_finish_without_matplotlib(tmp_path, monkeypatch, caplog):
    """Where matplotlib is missing (the GPU machine), ``finish`` writes
    ``draw.zoic``, draws no PNG, warns and returns None."""
    import logging

    monkeypatch.setattr(session, "can_render", lambda: False)
    cam = zpt.Camera(_thinlens_cfg(draw=True, draw_stride=64), "cpu")
    cam.create_rays(*map(torch.from_numpy, _samples(512, 0)), seed=0)
    with caplog.at_level(logging.WARNING, logger="zoic"):
        assert cam.finish(out_dir=str(tmp_path)) is None
    assert os.listdir(tmp_path) == ["draw.zoic"]
    assert "matplotlib is not installed" in caplog.text
    assert len(dump.parse_file(str(tmp_path / "draw.zoic"))["RAYS"]) == 8


def test_draw_off_records_nothing(tmp_path):
    cam = zpt.Camera(_thinlens_cfg(), "cpu")
    cam.create_rays(*map(torch.from_numpy, _samples(256, 0)), seed=0)
    assert not cam._draw_segments
    assert cam.finish(out_dir=str(tmp_path)) is None
    assert not os.listdir(tmp_path)


def test_camera_draw_raytraced_keeps_the_rays(tmp_path):
    """Draw mode adds the tape beside the call: the rays are the draw-off
    call's bits, the segments the tape of the call's samples at
    ``draw_stride``, accumulated over calls; ``update`` keeps draw mode.
    The camera compiles without the pre-check and with a small LUT, to
    keep the compile short on the CPU."""
    _, cfg = _cfgs(pupil_precheck=False, lut_bounds_samples=5_000,
                   debug=zpt.DebugOptions(draw=True, draw_stride=16))
    samples = list(map(torch.from_numpy, _samples(512, 7)))
    cam = zpt.Camera(cfg, "cpu")
    got, _ = cam.create_rays(*samples, seed=3)
    want, _ = zpt.create_rays(cam.state, cfg.replace(debug=zpt.DebugOptions()),
                              *samples, seed=3)
    for f in ("origin", "dir", "weight", "d_ody", "d_ddy"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    seg = tape.raytraced_tape(cam.state, cfg, *samples, stride=16)
    assert len(seg) > 32
    np.testing.assert_array_equal(cam._draw_segments[0], seg)
    cam.update(cfg.replace(exposure_control=0.5))
    cam.create_rays(*samples, seed=4)
    assert len(cam._draw_segments) == 2
    path = session.write_dump(cam.state, cam.config, cam._draw_segments,
                              str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["draw.zoic"]
    d = dump.parse_file(path)
    assert d["LENSMODEL"] == "KOLB" and len(d["RAYS"]) == 2 * len(seg)
    assert d["LENSES"].shape == (cam.state.lens.count, 3)


def test_render_debug_session_matches_jax(tmp_path, states, ref):
    pytest.importorskip("matplotlib")
    js, st = states
    _, cfg = _cfgs(debug=zpt.DebugOptions(draw=True,
                                          draw_stride=SESSION_STRIDE))
    samples = list(map(torch.from_numpy, _samples(N_SESSION, 2)))
    png, (rays, stats) = session.render_debug_session(
        st, cfg, *samples, out_dir=str(tmp_path), seed=1)
    assert os.path.exists(png) and rays.origin.shape == (N_SESSION, 3)
    assert int(stats.success) + int(stats.vignetted) == N_SESSION
    want_path = str(tmp_path / "jax.zoic")
    jdump.write(want_path, js.lens, ref["session"],
                sensor_height=float(cfg.sensor_height))
    with open(tmp_path / "draw.zoic") as f, open(want_path) as g:
        got_text, want_text = f.read(), g.read()
    header = got_text.index("RAYS{")
    assert got_text[:header] == want_text[:want_text.index("RAYS{")]
    _check_segments(dump.parse(got_text)["RAYS"],
                    jdump.parse(want_text)["RAYS"])


def test_diag_imports_neither_jax_nor_matplotlib():
    """Every module of the package imports without jax, ``zoic_tpu`` or
    matplotlib: only the two functions that draw a PNG import it."""
    code = (
        "import importlib, pkgutil, sys, zoic_tpu_torch; "
        "[importlib.import_module(m.name) for m in pkgutil.walk_packages("
        "zoic_tpu_torch.__path__, 'zoic_tpu_torch.')]; "
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'zoic_tpu', 'matplotlib')]; "
        "assert not bad, bad[:5]"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo,
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
