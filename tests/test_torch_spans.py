"""The port's spans (``utils.profiling.span``) on the CPU.

With no profiler recording, the port makes no ``record_function`` call:
each span is one flag read.  Under ``torch.profiler`` the lens compile,
``Camera.create_rays`` on both models' kernel paths and the module-level
``create_rays`` on the eager path record the spans that their path passes,
each under the parent listed here (the profiler's own parent links, read
up to the nearest ``zoic.*`` span).  The two spans on cache misses,
``zoic.tables.build`` and ``zoic.kernel.load``, open only on the card
(``tests/test_torch_cuda.py``).
"""

import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import zoic_tpu_torch as zpt
from zoic_tpu_torch.utils import profiling
from _torch_threads import one_thread  # noqa: F401

COMPILE = [("zoic.update", None), ("zoic.compile", "zoic.update")] + [
    (f"zoic.compile.{p}", "zoic.compile") for p in (
        "parse", "solve", "iris_probe", "lut", "precheck", "bokeh",
        "to_device")] + [
    (f"zoic.precheck.{p}", "zoic.compile.precheck") for p in (
        "covers", "harmonic", "circles", "pick", "poly")]
CALL = [("zoic.camera.create_rays", None),
        ("zoic.create_rays", "zoic.camera.create_rays"),
        ("zoic.kernel_inputs", "zoic.create_rays"),
        ("zoic.totals", "zoic.camera.create_rays")]
RAYTRACED = CALL + [("zoic.bokeh.sample", "zoic.kernel_inputs"),
                    ("zoic.bokeh.planes", "zoic.kernel_inputs"),
                    ("zoic.raytraced", "zoic.create_rays")]
# both camera kernels write finished rays: no epilogue pass
THINLENS = CALL + [("zoic.bokeh.sample", "zoic.kernel_inputs"),
                   ("zoic.thinlens.retry_planes", "zoic.kernel_inputs"),
                   ("zoic.bokeh.sample", "zoic.thinlens.retry_planes"),
                   ("zoic.thinlens", "zoic.create_rays")]
EAGER = [("zoic.create_rays", None)]


@pytest.fixture(scope="module")
def cameras(tmp_path_factory):
    """A raytraced camera (LUT, pre-check, image bokeh; 8 film radii and
    2,000 samples each, to stay cheap) and a thin lens with depth of
    field, vignetting and image bokeh, so that every span of a call opens;
    and the samples of one call."""
    yy, xx = np.mgrid[-1:1:32j, -1:1:32j]
    img = ((xx**2 + yy**2) < 0.8).astype(np.float32)
    bokeh = str(tmp_path_factory.mktemp("spans") / "disk.npy")
    np.save(bokeh, np.stack([img, img, img], -1))
    raytraced = zpt.CameraConfig(
        lens_model=zpt.LensModel.RAYTRACED,
        lens_data_path=zpt.data.lens_path("double_gauss_f2.0"),
        focal_length=5.0, fstop=2.0, focal_distance=100.0,
        lut_film_samples=8, lut_bounds_samples=2_000, use_image=True,
        bokeh_path=bokeh)
    thin = zpt.CameraConfig(
        lens_model=zpt.LensModel.THINLENS, focal_length=5.0, fstop=1.4,
        focal_distance=100.0, use_dof=True, optical_vignetting_distance=1.0,
        optical_vignetting_radius=1.0, use_image=True, bokeh_path=bokeh)
    u = torch.rand((4, 512), generator=torch.Generator().manual_seed(3))
    samples = (u[0] * 2 - 1, u[1] * 2 - 1, u[2], u[3])
    return {"raytraced": zpt.Camera(raytraced, "cpu"),
            "thinlens": zpt.Camera(thin, "cpu"), "samples": samples}


def _run(cameras, path, focus):
    """One step of ``path``: ``Camera.update`` to ``focus`` (a recompile),
    a kernel-path ``Camera.create_rays``, or the eager path's
    module-level ``create_rays``."""
    samples = cameras["samples"]
    if path == "update":
        cam = cameras["raytraced"]
        cam.update(cam.config.replace(focal_distance=focus))
    elif path == "eager":
        cam = cameras["thinlens"]
        # the concentric sampler: image bokeh would draw through the
        # sampler's wrapper, and so open its span
        zpt.create_rays(cam.state,
                        cam.config.replace(impl="jnp", use_image=False),
                        *samples, seed=7)
    else:
        cameras[path].create_rays(*samples, seed=7)


def _zoic_parent(event):
    q = event.cpu_parent
    while q is not None and not q.name.startswith("zoic."):
        q = q.cpu_parent
    return None if q is None else q.name


def test_a_span_is_a_flag_read_without_a_profiler():
    """Outside a profiler every span is the one shared no-op context;
    inside, a ``record_function`` range of that name."""
    assert profiling.span("a") is profiling.span("b")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("zoic.test"):
            pass
    assert [e.name for e in prof.events() if e.name == "zoic.test"] == [
        "zoic.test"]


@pytest.mark.parametrize("path", ["update", "raytraced", "thinlens", "eager"])
def test_no_record_function_without_a_profiler(cameras, monkeypatch, path):
    """With no profiler recording, the port calls no ``record_function``:
    it is made to raise, and the compile and the calls still run."""
    def refuse(name, *args, **kw):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    _run(cameras, path, focus=200.0)


@pytest.mark.parametrize("path,spans", [
    ("update", COMPILE), ("raytraced", RAYTRACED), ("thinlens", THINLENS),
    ("eager", EAGER)])
def test_spans_nest_as_listed_under_the_profiler(cameras, path, spans):
    """Each span of the path once (the thin lens's sampler twice: the
    attempt-0 draws and the retry planes) under its listed parent, and no
    other ``zoic.*`` span."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run(cameras, path, focus=300.0)
    got = collections.Counter(
        (e.name, _zoic_parent(e)) for e in prof.events()
        if e.name.startswith("zoic."))
    assert got == collections.Counter(spans)
