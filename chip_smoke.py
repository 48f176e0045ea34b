"""Smoke test of the PyTorch port on one CUDA card.

Drives the port's paths once each at the benchmark's batch (4,194,304
rays), through the entry points a user calls:

* the raytraced Double Gauss camera (focal length 5 cm, f/2, focus 100 cm,
  exit-pupil LUT and pupil pre-check on, max_tries 25) through
  ``zoic_tpu_torch.create_rays`` on the compiled state shipped with the
  port;
* the thin-lens camera through ``zoic_tpu_torch.compile_camera`` and
  ``create_rays``: the benchmark's three thin-lens configs (f/1.4 with
  depth of field, with empirical vignetting, with image bokeh from a 64x64
  disk made here), a pinhole and image bokeh with vignetting;
* the other raytraced cameras of the benchmark (``bench.py --all``) on
  their shipped states, each a variant of the raytraced kernel: the
  fisheye (harmonic bound, per-key select chain), the Petzval f/1.25 and
  the iris-less telephoto f/5 at focus 30, 100 and 1000 cm (circle bound,
  select chain, most of the film dead), the headline with image bokeh
  (presampled offsets and retry planes, square-domain pre-check); then
  the headline lens with naive first-element shaping, and the headline
  without the pre-check;
* the lens compile: every camera of ``zoic_tpu_torch.data.CAMERAS``
  compiled on the card from the port's lens files by ``compile_camera``
  and held against its shipped state (the lens-decided static fields
  exactly, the solve's scalars to 1e-5, the LUT and bound by what they
  do: attempts/ray and the vignetted fraction of ``create_rays`` on both);
* the op-rate microbenchmark kernel, its 13 cases against their plain
  versions (bit-equal) and beside their bounds, the fma case also with
  contraction on;
* the bench, ``python -m zoic_tpu_torch.bench``'s headline, which
  measures its peak op rate with the microbenchmark kernel.

The raytraced kernel schedules its rays dynamically (warps take whichever
rays are ready), so it is also held to what must not depend on the
schedule: two launches on the same inputs give the same bits, batches
that do not fill a warp, a block or the persistent grid equal the plain
version, and the kernel's lane-counting build (how full the warps are when
they draw and trace, on five cameras) gives the main build's tries.

    python3 chip_smoke.py

Phases, one line each: the device; the kernel builds (seven ``nvcc`` runs
in parallel: four sources, the microbenchmark twice, the two camera
kernels' counting builds); then per camera the run through ``create_rays``
checked for launches, finite outputs and its run counters, the kernel
against its plain PyTorch version on the same inputs, and timings with
CUDA events and, for the kernel's own time on the card, torch.profiler;
the bokeh kernel against its plain version on 4,194,304 draws (bit-equal);
ragged batches; lane use; the compiles; the microbenchmark; the bench's
JSON line.  Then one JSON line per the kernel table, the
card's name and power limit from nvidia-smi, and last ``{"ok": true,
"device": ...}``.  Any failed check exits non-zero before the last line.
It needs a CUDA card and ``nvcc``, and imports nothing of jax.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

BATCH = 4_194_304
MAX_TRIES = 25
SEED = 20261016
# kernel vs plain: tries/tir may differ on at most 0.01% of rays (borderline
# compares under a different atan2f build); payloads of rays whose tries
# agree and are live must agree to 1e-5 absolute
MAX_TRIES_MISMATCH = 419
PAYLOAD_ATOL = 1e-5
KERNELS = ("raytraced", "thinlens", "bokeh", "roofline")
# the builds: every source with --fmad=false, the microbenchmark also with
# fma contraction on
COUNT_LANES = ("ZOIC_COUNT_LANES",)
BUILDS = (*KERNELS, ("roofline", True), ("raytraced", False, COUNT_LANES),
          ("thinlens", False, COUNT_LANES))
# batches that do not fill a warp, a tile row or (the last, plus what
# main() adds: just under one block per SM) the persistent grid
RAGGED_SIZES = (1, 31, 33, 2_125)
PROFILED_CALLS = 5
# the card's published peaks (H100 SXM datasheet): HBM
# bytes/s, and float32 outside the tensor cores, 67 TFLOP/s counting an FMA
# as two; one element-op per lane per clock is half of it
HBM_BYTES_PER_S = 3.35e12
F32_ELEMENT_OPS_PER_S = 67e12 / 2
# element-ops per ray: the raytraced kernel's is the bench's work count
# (zoic_tpu_torch.bench.USEFUL_OPS_PER_RAY); the thin-lens kernel's and the
# bokeh kernel's are upper estimates from their sources, far below their
# byte bounds either way
THINLENS_OPS_PER_RAY = 60
BOKEH_OPS_PER_DRAW = 30
# compile vs shipped state: solve scalars relative, create_rays attempts/ray
# relative and vignetted fraction absolute
SOLVE_RTOL = 1e-5
ATTEMPTS_RTOL = 0.02
VIGNETTED_ATOL = 0.01
# static fields decided by the lens alone, and those decided by Monte-Carlo
# estimates (the pre-check's form, its polynomial gate, the dead-film
# fraction's first decimal): the compile draws from a torch.Generator, the
# shipped states from jax.random, and a near tie can go either way
LENS_STATICS = ("aperture_element", "iris_identity", "elem_flags",
                "profile_domain")
MC_STATICS = ("profile_kind", "profile_poly", "dead_frac")
SOLVE_SCALARS = ("origin_shift", "user_aperture_radius", "focal_length_ratio",
                 "traced_focal_length", "aperture_distance")
# the bench phase: the headline at the full batch, iterations cut
BENCH_ARGS = ("--batch", str(BATCH), "--iters", "2", "--inner", "8")
# raytraced phases after the headline: (phase, shipped camera
# (zoic_tpu_torch.data.CAMERAS), config changes, time the plain version)
RAYTRACED_CAMERAS = (
    ("raytraced_fisheye", "raytraced_fisheye", {}, True),
    ("raytraced_petzval_f1.25_focus30", "raytraced_petzval_f1.25_focus30",
     {}, False),
    ("raytraced_petzval_f1.25_focus100", "raytraced_petzval_f1.25_focus100",
     {}, False),
    ("raytraced_petzval_f1.25_focus1000",
     "raytraced_petzval_f1.25_focus1000", {}, False),
    ("raytraced_telephoto_f5.0_focus30", "raytraced_telephoto_f5.0_focus30",
     {}, True),
    ("raytraced_telephoto_f5.0_focus100",
     "raytraced_telephoto_f5.0_focus100", {}, False),
    ("raytraced_telephoto_f5.0_focus1000",
     "raytraced_telephoto_f5.0_focus1000", {}, False),
    ("raytraced_bokeh_image", "raytraced_bokeh_image", {}, True),
    ("raytraced_naive", "raytraced_naive", {}, False),
    ("raytraced_no_precheck", "headline", dict(pupil_precheck=False), False),
)


def check(cond, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def raytraced_config(zt, camera: str, bokeh_path: str = "", **changes):
    """The config of a shipped raytraced camera, max_tries 25."""
    cam = zt.data.CAMERAS[camera]
    kw = dict(cam.config_kwargs(), max_tries=MAX_TRIES, **changes)
    return zt.CameraConfig(
        lens_model=zt.LensModel.RAYTRACED,
        lens_data_path=zt.data.lens_path(cam.lens),
        bokeh_path=bokeh_path if cam.use_image else "",
        **kw,
    )


def thinlens_configs(zt, bokeh_path):
    """The benchmark's thin-lens configs (bench.py ``--all``), a pinhole
    and image bokeh with vignetting: every branch of the thin-lens kernel."""
    base = dict(lens_model=zt.LensModel.THINLENS, focal_length=5.0,
                fstop=1.4, focal_distance=100.0, max_tries=MAX_TRIES)
    vig = dict(optical_vignetting_distance=1.0, optical_vignetting_radius=1.0)
    img = dict(use_image=True, bokeh_path=bokeh_path)
    return {
        "thinlens_pinhole": zt.CameraConfig(**base, use_dof=False),
        "thinlens_f1.4": zt.CameraConfig(**base, use_dof=True),
        "thinlens_vignette": zt.CameraConfig(**base, use_dof=True, **vig),
        "thinlens_bokeh_image": zt.CameraConfig(**base, use_dof=True, **img),
        "thinlens_bokeh_vignette": zt.CameraConfig(**base, use_dof=True,
                                                   **img, **vig),
    }


def write_bokeh_disk(zt, root: str) -> str:
    """The benchmark's 64x64 disk bokeh image as an .npy under ``root``."""
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, "bokeh_disk64.npy")
    np.save(path, zt.data.bokeh_disk(64))
    return path


def draws(g: torch.Generator, b: int, device):
    sx = torch.rand(b, generator=g, device=device) * 2.0 - 1.0
    sy = torch.rand(b, generator=g, device=device) * 2.0 - 1.0
    lx = torch.rand(b, generator=g, device=device)
    ly = torch.rand(b, generator=g, device=device)
    return sx, sy, lx, ly


def time_ms(fn, make_args, warmup=3, iters=10):
    """Milliseconds of each timed ``fn(*make_args())`` by CUDA events, each
    call on fresh draws made outside the timed region."""
    times = []
    for it in range(warmup + iters):
        args = make_args()
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn(*args)
        t1.record()
        torch.cuda.synchronize()
        if it >= warmup:
            times.append(t0.elapsed_time(t1))
    return times


def profiled_kernels(fn, calls: int = PROFILED_CALLS):
    """torch.profiler's averages of the kernels (and copies) that ran on
    the card during ``calls`` calls of ``fn()``, after one warm-up call."""
    from zoic_tpu_torch.utils import profiling

    fn()
    torch.cuda.synchronize()
    log_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "chip_smoke", "trace")
    with profiling.trace(log_dir) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.device_time_total > 0]


def device_ms(fn, match: str) -> float:
    """The kernel's own milliseconds on the card per launch by ``fn()``:
    the mean device time of the kernels whose name holds ``match`` (the
    profiler may drop a record, so over the launches it kept)."""
    events = [e for e in profiled_kernels(fn) if match in e.key]
    check(events, f"the profiler saw no device time of a {match} kernel")
    return (sum(e.device_time_total for e in events)
            / sum(e.count for e in events) / 1e3)


def create_rays_split(fn, match: str) -> str:
    """Where one ``create_rays`` call's time on the card goes: the camera
    kernel (name holds ``match``), everything else, and the launches."""
    events = profiled_kernels(fn)
    own = sum(e.device_time_total for e in events if match in e.key)
    rest = sum(e.device_time_total for e in events if match not in e.key)
    n = sum(e.count for e in events)
    return (f"create_rays on the card: {match} {own / PROFILED_CALLS:.1f} "
            f"us, other kernels {rest / PROFILED_CALLS:.1f} us, "
            f"{n / PROFILED_CALLS:.1f} kernels per call (profiler, "
            f"{PROFILED_CALLS} calls)")


def bits_equal(a, b) -> bool:
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(a, b))


def reset_counts(trace_kernel, bokeh_kernel, roofline_kernel=None) -> None:
    trace_kernel.launches = 0
    trace_kernel.thinlens_launches = 0
    bokeh_kernel.launches = 0
    if roofline_kernel is not None:
        roofline_kernel.launches = 0


def bound(bytes_moved: float, ops: float):
    """``(bound_ms, bound_by)``: the larger of the bytes over the card's
    memory rate and the element-ops over its f32 rate."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / F32_ELEMENT_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def median_line(timed) -> str:
    parts = []
    for name, ts in timed.items():
        med = statistics.median(ts)
        parts.append(f"{name} {med:.4f} ms = {BATCH / med / 1e3:.1f} M "
                     f"rays/s (min {min(ts):.4f}, max {max(ts):.4f})")
    return "; ".join(parts)


def raytraced_phase(zt, trace_kernel, bokeh_kernel, name, state, cfg, dev,
                    smi, tags, time_plain=True, headline=False):
    """Drive one raytraced camera through create_rays, check the run, hold
    the kernel against its plain version on the same inputs, seed and
    retry planes, and time kernel, create_rays and, with ``time_plain``,
    the plain version.  ``tags`` label the three lines; the headline
    camera is also held to its attempts/ray and vignetted fraction."""
    from zoic_tpu_torch.models import raytraced as rt_model

    g = torch.Generator(device=dev).manual_seed(SEED)
    sx, sy, lx, ly = draws(g, BATCH, dev)

    reset_counts(trace_kernel, bokeh_kernel)
    rays, stats = zt.create_rays(state, cfg, sx, sy, lx, ly, generator=g)
    torch.cuda.synchronize()
    n_launch, n_bokeh = trace_kernel.launches, bokeh_kernel.launches
    check(n_launch > 0, f"{name}: no raytraced kernel launch")
    check(trace_kernel.thinlens_launches == 0,
          f"{name}: a thinlens kernel launched")
    check((n_bokeh > 0) == cfg.use_image,
          f"{name}: {n_bokeh} bokeh launches with use_image={cfg.use_image}")
    for f in ("origin", "dir", "weight", "d_ody", "d_ddy"):
        t = getattr(rays, f)
        check(t.device == dev and bool(torch.isfinite(t).all()),
              f"{name}: rays.{f} not finite on {dev}")
    check(rays.origin.shape == (BATCH, 3) and rays.dir.shape == (BATCH, 3),
          f"{name}: unexpected output shapes")
    success, vig = int(stats.success), int(stats.vignetted)
    check(success + vig == BATCH,
          f"{name}: success {success} + vignetted {vig} != B")
    attempts = 1.0 + int(stats.tries_total) / BATCH
    vig_frac = vig / BATCH
    if headline:
        check(1.0 <= attempts <= 3.0,
              f"{name}: attempts/ray {attempts} outside [1, 3]")
        check(vig_frac < 0.01, f"{name}: vignetted fraction {vig_frac} >= 1%")
    live = rays.weight > 0
    check(bool(live.any()), f"{name}: no live ray")
    norm_err = float((rays.dir[live].norm(dim=1) - 1.0).abs().max())
    check(norm_err < 1e-4, f"{name}: live directions not unit: {norm_err}")
    print(f"[{tags[0]}] launches raytraced {n_launch} bokeh {n_bokeh}; "
          f"success {success} vignetted {vig} tir {int(stats.tir)}; "
          f"attempts/ray {attempts:.6f}; vignetted frac {vig_frac:.6f}; "
          f"max ||dir|-1| {norm_err:.2e}", flush=True)

    # kernel vs plain on the same inputs, seed and retry planes
    seed = SEED % (1 << 22)
    u1, u2, kw = rt_model.kernel_inputs(state, cfg, lx, ly, seed)
    args = (state.lens, sx, sy, u1, u2, state.sensor_width, seed)
    ko, kd, kt, ktir = trace_kernel.raytraced_fused(*args, **kw)
    po, pd, pt, ptir = trace_kernel.raytraced_plain(*args, **kw)
    torch.cuda.synchronize()
    mismatch = int(((kt != pt) | (ktir != ptir)).sum())
    same = (kt == pt) & (ktir == ptir) & (kt <= cfg.max_tries)
    err_o = float((ko - po)[same].abs().max())
    err_d = float((kd - pd)[same].abs().max())
    err_all = max(float((ko - po).abs().max()), float((kd - pd).abs().max()))
    max_abs_err = max(err_o, err_d)
    print(f"[{tags[1]}] tries/tir mismatches {mismatch} of {BATCH} "
          f"(limit {MAX_TRIES_MISMATCH}); live max |d origin| {err_o:.3e} "
          f"|d dir| {err_d:.3e} (limit {PAYLOAD_ATOL}); all rays "
          f"{err_all:.3e}", flush=True)
    check(mismatch <= MAX_TRIES_MISMATCH,
          f"{name}: kernel and plain disagree on tries")
    check(max_abs_err <= PAYLOAD_ATOL,
          f"{name}: kernel and plain payloads disagree")
    # the schedule is dynamic, the result must not be
    again = trace_kernel.raytraced_fused(*args, **kw)
    check(bits_equal(again, (ko, kd, kt, ktir)),
          f"{name}: two launches on the same inputs differ")
    dev_ms = device_ms(lambda: trace_kernel.raytraced_fused(*args, **kw),
                       "raytraced_kernel")

    # timings (information only), fresh draws, seed and planes per call
    tg = torch.Generator(device=dev).manual_seed(SEED + 1)

    def fresh():
        s = int(torch.randint(0, 1 << 22, (), generator=tg, device=dev))
        a, b, c, d = draws(tg, BATCH, dev)
        c, d, fkw = rt_model.kernel_inputs(state, cfg, c, d, s)
        return (state.lens, a, b, c, d, state.sensor_width, s, fkw)

    def e2e_args():
        return (*draws(tg, BATCH, dev),
                int(torch.randint(0, 1 << 22, (), generator=tg, device=dev)))

    timed = {"kernel": time_ms(
        lambda *a: trace_kernel.raytraced_fused(*a[:7], **a[7]), fresh)}
    if time_plain:
        timed["plain"] = time_ms(
            lambda *a: trace_kernel.raytraced_plain(*a[:7], **a[7]), fresh)
    timed["create_rays"] = time_ms(
        lambda *a: zt.create_rays(state, cfg, *a[:4], seed=a[4]), e2e_args)
    print(f"[{tags[2]}] median of 10 (3 warm-up), B = {BATCH}, on {smi}: "
          + median_line(timed) + f"; kernel on the card {dev_ms:.4f} ms "
          f"(profiler, {PROFILED_CALLS} launches); two launches bit-equal; "
          + create_rays_split(
              lambda: zt.create_rays(state, cfg, sx, sy, lx, ly, seed=seed),
              "raytraced_kernel"), flush=True)
    planes = [t for t in (kw["retry_u1"], kw["retry_u2"]) if t is not None]
    return {"launches": n_launch, "bokeh_launches": n_bokeh,
            "bytes": nbytes(sx, sy, u1, u2, ko, kd, kt, ktir, *planes),
            "max_abs_err": max_abs_err, "mismatches": mismatch,
            "attempts": attempts, "vignetted_frac": vig_frac,
            "kernel_ms": statistics.median(timed["kernel"]),
            "device_ms": dev_ms,
            "plain_ms": (statistics.median(timed["plain"])
                         if time_plain else None),
            "create_rays_ms": statistics.median(timed["create_rays"])}


def thinlens_phase(zt, trace_kernel, bokeh_kernel, name, cfg, dev, smi,
                   tag):
    """Drive one thin-lens config through compile_camera + create_rays,
    check the run, hold the kernel against its plain version on the same
    inputs, and time kernel, plain and create_rays."""
    from zoic_tpu_torch.models import thinlens as thin_model

    state = zt.compile_camera(cfg, dev)
    g = torch.Generator(device=dev).manual_seed(SEED)
    sx, sy, lx, ly = draws(g, BATCH, dev)

    reset_counts(trace_kernel, bokeh_kernel)
    rays, stats = zt.create_rays(state, cfg, sx, sy, lx, ly, generator=g)
    torch.cuda.synchronize()
    n_thin, n_bokeh = trace_kernel.thinlens_launches, bokeh_kernel.launches
    check(n_thin > 0, f"{name}: no thinlens kernel launch")
    check(trace_kernel.launches == 0, f"{name}: a raytraced kernel launched")
    check((n_bokeh > 0) == cfg.use_image,
          f"{name}: {n_bokeh} bokeh launches with use_image={cfg.use_image}")
    for f in ("origin", "dir", "weight", "d_ody", "d_ddy"):
        t = getattr(rays, f)
        check(t.device == dev and bool(torch.isfinite(t).all()),
              f"{name}: rays.{f} not finite on {dev}")
    check(rays.origin.shape == (BATCH, 3) and rays.dir.shape == (BATCH, 3),
          f"{name}: unexpected output shapes")
    success, vig = int(stats.success), int(stats.vignetted)
    if cfg.use_dof:
        check(success + vig == BATCH,
              f"{name}: success {success} + vignetted {vig} != B")
    else:
        check(success == vig == 0 and bool((rays.weight == 1.0).all()),
              f"{name}: pinhole weights or counters")
    attempts = 1.0 + int(stats.tries_total) / BATCH
    live = rays.weight > 0
    norm_err = float((rays.dir[live].norm(dim=1) - 1.0).abs().max())
    check(norm_err < 1e-4, f"{name}: live directions not unit: {norm_err}")
    print(f"[{tag}a {name}] launches thinlens {n_thin} bokeh {n_bokeh}; "
          f"success {success} vignetted {vig}; attempts/ray {attempts:.6f};"
          f" max ||dir|-1| {norm_err:.2e}", flush=True)

    # kernel vs plain on the same inputs, seed and retry planes
    has_ov = cfg.optical_vignetting_distance > 0.0
    seed = SEED % (1 << 22)
    u1, u2 = lx, ly
    planes = {}
    if cfg.use_image:
        u1, u2 = zt.bokeh.sample(state.bokeh, lx, ly)
        if has_ov:
            ru1, ru2 = thin_model.retry_planes(state, cfg, BATCH, g)
            planes = dict(retry_u1=ru1, retry_u2=ru2)
    args = (sx, sy, u1, u2, state.tan_fov, state.aperture_radius,
            state.focal_distance, state.ov_distance, state.ov_radius, seed)
    kw = dict(use_dof=cfg.use_dof, has_ov=has_ov, max_tries=cfg.max_tries,
              presampled=cfg.use_image, **planes)
    ko, kd, kt = trace_kernel.thinlens_fused(*args, **kw)
    po, pd, pt = trace_kernel.thinlens_plain(*args, **kw)
    torch.cuda.synchronize()
    mismatch = int((kt != pt).sum())
    same = (kt == pt) & (kt <= cfg.max_tries)
    err = max(float((ko - po)[same].abs().max()),
              float((kd - pd)[same].abs().max()))
    err_all = max(float((ko - po).abs().max()), float((kd - pd).abs().max()))
    print(f"[{tag}b {name} kernel vs plain] tries mismatches {mismatch} of "
          f"{BATCH} (limit {MAX_TRIES_MISMATCH}); live max |d| {err:.3e} "
          f"(limit {PAYLOAD_ATOL}); all rays {err_all:.3e}", flush=True)
    check(mismatch <= MAX_TRIES_MISMATCH, f"{name}: kernel and plain "
          "disagree on tries")
    check(err <= PAYLOAD_ATOL, f"{name}: kernel and plain payloads disagree")

    # timings (information only), fresh draws and seed per call
    tg = torch.Generator(device=dev).manual_seed(SEED + 1)

    def fresh():
        s = int(torch.randint(0, 1 << 22, (), generator=tg, device=dev))
        a, b, c, d = draws(tg, BATCH, dev)
        if cfg.use_image:
            c, d = bokeh_kernel.sample_fused(state.bokeh, c, d)
        return (a, b, c, d, *args[4:9], s)

    def e2e_args():
        return (*draws(tg, BATCH, dev),
                int(torch.randint(0, 1 << 22, (), generator=tg, device=dev)))

    timed = {
        "kernel": time_ms(lambda *a: trace_kernel.thinlens_fused(*a, **kw),
                          fresh),
        "plain": time_ms(lambda *a: trace_kernel.thinlens_plain(*a, **kw),
                         fresh),
        "create_rays": time_ms(
            lambda *a: zt.create_rays(state, cfg, *a[:4], seed=a[4],
                                      generator=tg), e2e_args),
    }
    dev_ms = device_ms(lambda: trace_kernel.thinlens_fused(*args, **kw),
                       "thinlens_kernel")
    print(f"[{tag}c {name} timing] median of 10 (3 warm-up), B = {BATCH}, "
          f"on {smi}: " + median_line(timed) + f"; kernel on the card "
          f"{dev_ms:.4f} ms (profiler, {PROFILED_CALLS} launches); "
          + create_rays_split(
              lambda: zt.create_rays(state, cfg, sx, sy, lx, ly, seed=seed,
                                     generator=g), "thinlens_kernel"),
          flush=True)
    return {"thinlens_launches": n_thin, "bokeh_launches": n_bokeh,
            "bytes": nbytes(*args[:4], ko, kd, kt, *planes.values()),
            "max_abs_err": err,
            "kernel_ms": statistics.median(timed["kernel"]),
            "device_ms": dev_ms,
            "plain_ms": statistics.median(timed["plain"]),
            "create_rays_ms": statistics.median(timed["create_rays"])}


def bokeh_phase(zt, bokeh_kernel, bokeh_path, dev, smi, tag):
    """The bokeh kernel against its plain version on B draws: bit-equal."""
    image = zt.bokeh.load(bokeh_path).to(dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    u1 = torch.rand(BATCH, generator=g, device=dev)
    u2 = torch.rand(BATCH, generator=g, device=dev)
    kdx, kdy = bokeh_kernel.sample_fused(image, u1, u2)
    pdx, pdy = bokeh_kernel.sample_plain(image, u1, u2)
    torch.cuda.synchronize()
    bits = [int((k.view(torch.int32) != p.view(torch.int32)).sum())
            for k, p in ((kdx, pdx), (kdy, pdy))]
    err = max(float((kdx - pdx).abs().max()), float((kdy - pdy).abs().max()))
    print(f"[{tag}a bokeh kernel vs plain] {image.height}x{image.width} "
          f"image, {BATCH} draws: bit mismatches dx {bits[0]} dy {bits[1]} "
          f"(limit 0); max |d| {err:.3e}", flush=True)
    check(bits == [0, 0], "bokeh kernel and plain are not bit-equal")

    def fresh():
        return (image, torch.rand(BATCH, generator=g, device=dev),
                torch.rand(BATCH, generator=g, device=dev))

    timed = {"kernel": time_ms(bokeh_kernel.sample_fused, fresh),
             "plain": time_ms(bokeh_kernel.sample_plain, fresh)}
    dev_ms = device_ms(lambda: bokeh_kernel.sample_fused(image, u1, u2),
                       "bokeh_kernel")
    print(f"[{tag}b bokeh timing] median of 10 (3 warm-up), B = {BATCH} "
          f"draws, on {smi}: " + median_line(timed).replace("rays/s",
                                                            "draws/s")
          + f"; kernel on the card {dev_ms:.4f} ms (profiler)", flush=True)
    tables = [getattr(image, f) for f in ("cdf_row", "row_indices", "cdf_col",
                                          "dx_col", "dy_srow")]
    return {"max_abs_err": err, "bytes": nbytes(u1, u2, kdx, kdy, *tables),
            "kernel_ms": statistics.median(timed["kernel"]),
            "device_ms": dev_ms,
            "plain_ms": statistics.median(timed["plain"])}


def ragged_phase(zt, trace_kernel, name, state, cfg, sizes, dev, tag):
    """The raytraced kernel against its plain version at batches that do not
    fill a warp, a block or the persistent grid: tries and tir equal,
    payloads of live rays within the tolerance, on inputs, seed and (with
    image bokeh) retry planes made for each size."""
    from zoic_tpu_torch.models import raytraced as rt_model

    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    seed = (SEED + 4) % (1 << 22)
    worst = 0.0
    for n in sizes:
        sx, sy, lx, ly = draws(g, n, dev)
        u1, u2, kw = rt_model.kernel_inputs(state, cfg, lx, ly, seed)
        args = (state.lens, sx, sy, u1, u2, state.sensor_width, seed)
        ko, kd, kt, ktir = trace_kernel.raytraced_fused(*args, **kw)
        po, pd, pt, ptir = trace_kernel.raytraced_plain(*args, **kw)
        torch.cuda.synchronize()
        check(ko.shape == (n, 3) and kt.shape == (n,),
              f"{name}: output shapes at B = {n}")
        check(bool((kt == pt).all()) and bool((ktir == ptir).all()),
              f"{name}: kernel and plain disagree on tries at B = {n}")
        live = kt <= cfg.max_tries
        if bool(live.any()):
            worst = max(worst, float((ko - po)[live].abs().max()),
                        float((kd - pd)[live].abs().max()))
        check(worst <= PAYLOAD_ATOL,
              f"{name}: kernel and plain payloads disagree at B = {n}")
    print(f"[{tag} {name} ragged batches] B = {', '.join(map(str, sizes))}: "
          f"tries/tir equal to the plain version's, live max |d| "
          f"{worst:.3e} (limit {PAYLOAD_ATOL})", flush=True)


def lane_use_phase(dev, smi, tag):
    """How full the warps are when they draw and trace: the camera kernels'
    counting builds on five raytraced cameras and the thin lens with
    vignetting, each held to the main build's tries (and tir)."""
    from zoic_tpu_torch.tools import lane_use

    seed = SEED % (1 << 22)
    rows = {name: lane_use.raytraced_row(name, BATCH, seed, dev)
            for name in lane_use.RAYTRACED}
    rows["thinlens_vignette"] = lane_use.thinlens_row(BATCH, seed, dev)
    for i, (name, r) in enumerate(rows.items()):
        print(f"[{tag}.{i} lane use {name}] B = {BATCH}, on {smi}: "
              + ", ".join(f"{k} {v:.4f}" if isinstance(v, float)
                          else f"{k} {v}" for k, v in r.items()), flush=True)
        check(r["equal"], f"{name}: the counting build's tries differ from "
              "the main build's")
    return rows


def lens_statics(lens) -> dict:
    out = {f: getattr(lens, f) for f in LENS_STATICS + MC_STATICS
           if f != "profile_kind"}
    out["profile_kind"] = lens.profile.kind if lens.profile else None
    return out


def compile_phase(zt, trace_kernel, bokeh_kernel, bokeh_path, dev, smi, tag):
    """Every camera of ``zt.data.CAMERAS`` compiled on the card from the
    port's lens files, against the state the JAX package compiled: the
    lens-decided static fields exactly, the solve's scalars to
    ``SOLVE_RTOL``, and the LUT and pre-check bound by what they do, since
    the draws differ: ``create_rays`` on both states on the same inputs and
    seed, attempts/ray within ``ATTEMPTS_RTOL`` and the vignetted fraction
    within ``VIGNETTED_ATOL``.  The Monte-Carlo-decided statics are
    printed beside the shipped ones."""
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    sx, sy, lx, ly = draws(g, BATCH, dev)
    seed = (SEED + 3) % (1 << 22)
    out = {}
    for i, name in enumerate(zt.data.CAMERAS):
        cfg = raytraced_config(zt, name, bokeh_path)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = zt.compile_camera(cfg, dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        ref = zt.load_state(zt.data.state_path(name), device=dev)
        got, want = lens_statics(st.lens), lens_statics(ref.lens)
        for f in LENS_STATICS:
            check(got[f] == want[f],
                  f"compile {name}: {f} {got[f]!r} != shipped {want[f]!r}")
        rel = {}
        for f in SOLVE_SCALARS:
            a, b = float(getattr(st.lens, f)), float(getattr(ref.lens, f))
            rel[f] = abs(a - b) / abs(b) if b != 0.0 else abs(a)
            check(rel[f] <= SOLVE_RTOL,
                  f"compile {name}: {f} {a} vs shipped {b}")
        stats = [zt.create_rays(s_, cfg, sx, sy, lx, ly, seed=seed)[1]
                 for s_ in (st, ref)]
        att = [1.0 + int(s_.tries_total) / BATCH for s_ in stats]
        vig = [int(s_.vignetted) / BATCH for s_ in stats]
        mc = {f: (got[f], want[f]) for f in MC_STATICS}
        print(f"[{tag}.{i} compile {name}] {secs:.2f} s; lens statics equal; "
              f"max solve rel err {max(rel.values()):.2e} (limit "
              f"{SOLVE_RTOL}); attempts/ray {att[0]:.6f} vs shipped "
              f"{att[1]:.6f}; vignetted {vig[0]:.6f} vs {vig[1]:.6f}; "
              f"Monte-Carlo statics (compiled, shipped) {mc}", flush=True)
        check(abs(att[0] - att[1]) <= ATTEMPTS_RTOL * att[1],
              f"compile {name}: attempts/ray {att[0]} vs shipped {att[1]}")
        check(abs(vig[0] - vig[1]) <= VIGNETTED_ATOL,
              f"compile {name}: vignetted {vig[0]} vs shipped {vig[1]}")
        out[name] = {"compile_s": secs, "attempts": att, "vignetted": vig,
                     "mc_statics_equal": all(a == b for a, b in mc.values())}
    print(f"[{tag} compile summary] on {smi}: seconds per compile " + ", ".join(
        f"{n} {r['compile_s']:.2f}" for n, r in out.items()), flush=True)
    return out


def roofline_phase(rk, roofline, profiling, dev, smi, tag):
    """The op-rate microbenchmark kernel: each case against its plain
    version at the tool's default shape (bit-equal in the ``--fmad=false``
    build), then each case's element-op rate beside its bound, and the fma
    case with contraction on."""
    tile, grid, reps, ns = 128, 512, 512, 4
    sms, clock = roofline.card_limits(dev)
    rows = {}
    for name in rk.CASES:
        x = torch.full((ns, tile, rk.LANES), 3 if name == "i32mix" else 1.234,
                       dtype=rk.dtype_of(name), device=dev)
        k = rk.roofline_fused(name, x, grid, reps)
        p = rk.roofline_plain(name, x, grid, reps)
        torch.cuda.synchronize()
        bits = int((k.view(torch.int32) != p.view(torch.int32)).sum())
        err = float((k.double() - p.double()).abs().max())
        check(bool(torch.isfinite(k.double()).all()),
              f"roofline {name}: non-finite output")
        rows[name] = {"bit_mismatches": bits, "max_abs_err": err}
    print(f"[{tag}a roofline kernel vs plain] [{ns}, {tile}, 128] x {grid} "
          f"grid steps x {reps} reps: bit mismatches "
          + ", ".join(f"{n} {r['bit_mismatches']}" for n, r in rows.items())
          + " (limit 0)", flush=True)
    check(all(r["bit_mismatches"] == 0 for r in rows.values()),
          "roofline kernel and plain are not bit-equal")
    for name in rk.CASES:
        rate, t = roofline.measure(name, tile, grid, reps, ns, device=dev)
        b = roofline.bound_seconds(name, tile, grid, reps, ns, sms, clock)
        rows[name].update(rate=rate, ms=t * 1e3, bound_ms=b * 1e3)
    rate_c, t_c = roofline.measure("fma", tile, grid, reps, ns, device=dev,
                                   contract=True)
    x = torch.full((ns, tile, rk.LANES), 1.234, device=dev)
    kc = rk.roofline_fused("fma", x, grid, reps, contract=True)
    pc = rk.roofline_plain("fma", x, grid, reps)
    contract_bits = int((kc.view(torch.int32) != pc.view(torch.int32)).sum())
    plain_s = profiling.time_fn(
        lambda v: rk.roofline_plain("fma", v, grid, reps), lambda: (x,),
        iters=3, warmup=1, bursts=3, device=dev)["median"]
    print(f"[{tag}b roofline rates] {sms} SMs at {clock / 1e6:.0f} MHz, on "
          f"{smi}: " + "; ".join(
              f"{n} {r['rate'] / 1e12:.3f} Top/s ({r['ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms, {r['bound_ms'] / r['ms']:.1%})"
              for n, r in rows.items())
          + f"; fma with contraction {rate_c / 1e12:.3f} Top/s "
          f"({t_c * 1e3:.4f} ms, {contract_bits} bits differ from plain); "
          f"plain fma {plain_s * 1e3:.4f} ms", flush=True)
    dev_ms = device_ms(lambda: rk.roofline_fused("fma", x, grid, reps),
                       "roofline_f32")
    # the fma case's bound for the kernel table: its dispatch-bound time, or the
    # block read and the output written at the memory rate if longer
    ops_ms = rows["fma"]["bound_ms"]
    bytes_ms = (nbytes(x) + nbytes(kc)) / HBM_BYTES_PER_S * 1e3
    return {"rows": rows, "contract_rate": rate_c, "contract_ms": t_c * 1e3,
            "contract_bit_mismatches": contract_bits,
            "ms": rows["fma"]["ms"], "device_ms": dev_ms,
            "plain_ms": plain_s * 1e3,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "max_abs_err": max(r["max_abs_err"] for r in rows.values())}


def bench_phase(trace_kernel, bokeh_kernel, rk, kind, tag):
    """``python -m zoic_tpu_torch.bench``'s headline at the full batch,
    iterations cut: its JSON line on a line of its own, checked, and the
    launches of the path (the microbenchmark for the peak, the raytraced
    kernel for the rays)."""
    from zoic_tpu_torch import bench

    buf = io.StringIO()
    reset_counts(trace_kernel, bokeh_kernel, rk)
    with contextlib.redirect_stdout(buf):
        bench.main(list(BENCH_ARGS))
    n_rt, n_roof = trace_kernel.launches, rk.launches
    line = buf.getvalue().strip().splitlines()[-1]
    print(line, flush=True)
    res = json.loads(line)
    keys = ("metric", "value", "unit", "vs_baseline", "attempts_per_ray",
            "vignetted_frac", "peak_tops", "mfu", "device")
    check(all(k in res for k in keys), f"bench line lacks keys: {res}")
    check(res["device"] == kind, f"bench ran on {res['device']}")
    for k in ("value", "peak_tops", "mfu", "attempts_per_ray"):
        check(math.isfinite(res[k]) and res[k] > 0, f"bench {k} = {res[k]}")
    check(1.0 <= res["attempts_per_ray"] <= 3.0 and res["vignetted_frac"] < 0.01,
          "bench headline attempts/ray or vignetted fraction off")
    check(n_rt > 0 and n_roof > 0,
          f"bench path launches: raytraced {n_rt}, roofline {n_roof}")
    print(f"[{tag} bench] {' '.join(BENCH_ARGS)}: launches raytraced {n_rt}, "
          f"roofline {n_roof}, thinlens {trace_kernel.thinlens_launches}, "
          f"bokeh {bokeh_kernel.launches}", flush=True)
    return {"launches": n_roof, "raytraced_launches": n_rt, "result": res}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke FAILED: torch.cuda.is_available() is "
                         "False; this smoke test needs a CUDA card")
    import zoic_tpu_torch as zt
    from zoic_tpu_torch.ops import _build, bokeh_kernel, trace_kernel
    from zoic_tpu_torch.ops import roofline_kernel
    from zoic_tpu_torch.tools import roofline
    from zoic_tpu_torch.utils import profiling

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    print(f"[1 device] {kind} | nvidia-smi: {smi} | torch {torch.__version__}"
          f" cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    _build.load_all(BUILDS)
    print(f"[2 build] csrc/{{{','.join(KERNELS)}}}.cu for sm_90a, roofline "
          f"also with contraction, raytraced and thinlens also counting "
          f"lanes, in {time.perf_counter() - t0:.2f} s (parallel nvcc)",
          flush=True)

    state = zt.load_state(zt.data.state_path(), device=dev)
    print(f"[3 inputs] state {zt.data.HEADLINE} on {dev}, {state.lens.count} "
          f"elements; B = {BATCH} draws from torch.Generator seed {SEED}",
          flush=True)
    # ---- main path through the public entry point, then the kernel
    # against its plain version and the timings
    rt = {"raytraced_headline": raytraced_phase(
        zt, trace_kernel, bokeh_kernel, "raytraced_headline", state,
        raytraced_config(zt, "headline"), dev, smi,
        ("4 main path", "5 kernel vs plain", "6 timing"), headline=True)}
    head = rt["raytraced_headline"]

    # ---- the thin-lens path, one config after another
    bokeh_path = write_bokeh_disk(zt, os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke"))
    thin = {}
    for i, (name, tcfg) in enumerate(thinlens_configs(zt, bokeh_path).items()):
        thin[name] = thinlens_phase(zt, trace_kernel, bokeh_kernel, name,
                                    tcfg, dev, smi, f"{7 + i}")
    # ---- the bokeh kernel against its plain version
    bk = bokeh_phase(zt, bokeh_kernel, bokeh_path, dev, smi, "12")

    # ---- the other raytraced cameras, one variant after another
    for i, (name, camera, changes, time_plain) in enumerate(
            RAYTRACED_CAMERAS):
        st = zt.load_state(zt.data.state_path(camera), device=dev)
        rcfg = raytraced_config(zt, camera, bokeh_path, **changes)
        tag = 13 + i
        rt[name] = raytraced_phase(
            zt, trace_kernel, bokeh_kernel, name, st, rcfg, dev, smi,
            (f"{tag}a {name}", f"{tag}b {name} kernel vs plain",
             f"{tag}c {name} timing"), time_plain=time_plain)
    print("[23 raytraced summary] " + json.dumps({
        name: {k: r[k] for k in ("kernel_ms", "device_ms", "plain_ms",
                                 "create_rays_ms", "attempts",
                                 "vignetted_frac", "mismatches")}
        for name, r in rt.items()}), flush=True)

    # ---- what must not depend on the schedule: ragged batches, lane use
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    sizes = (*RAGGED_SIZES, sms * 32 * trace_kernel.WARPS_PER_BLOCK - 29)
    ragged_phase(zt, trace_kernel, "raytraced_headline", state,
                 raytraced_config(zt, "headline"), sizes, dev, "23a")
    ragged_phase(zt, trace_kernel, "raytraced_bokeh_image",
                 zt.load_state(zt.data.state_path("raytraced_bokeh_image"),
                               device=dev),
                 raytraced_config(zt, "raytraced_bokeh_image", bokeh_path),
                 sizes, dev, "23b")
    lanes = lane_use_phase(dev, smi, "23c")

    # ---- the lens compile, the microbenchmark, the bench
    comp = compile_phase(zt, trace_kernel, bokeh_kernel, bokeh_path, dev, smi,
                         "24")
    roof = roofline_phase(roofline_kernel, roofline, profiling, dev, smi,
                          "25")
    bn = bench_phase(trace_kernel, bokeh_kernel, roofline_kernel, kind, "26")

    from zoic_tpu_torch.bench import USEFUL_OPS_PER_RAY

    rep = thin["thinlens_f1.4"]
    rt_bound = bound(head["bytes"], USEFUL_OPS_PER_RAY * BATCH)
    thin_bound = bound(rep["bytes"], THINLENS_OPS_PER_RAY * BATCH)
    bokeh_bound = bound(bk["bytes"], BOKEH_OPS_PER_DRAW * BATCH)
    entries = [{
        "name": "raytraced",
        "route": "cuda",
        "source": "zoic_tpu_torch/csrc/raytraced.cu",
        "replaces": "zoic_tpu/ops/trace_kernel.py:975",
        "launches": sum(r["launches"] for r in rt.values()),
        "max_abs_err": max(r["max_abs_err"] for r in rt.values()),
        "ms": head["kernel_ms"],
        "device_ms": head["device_ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": rt_bound[0],
        "bound_by": rt_bound[1],
        "library_ms": None,
        "config": "raytraced_headline",
        "configs": [name for name, r in rt.items() if r["launches"] > 0],
    }, {
        "name": "thinlens",
        "route": "cuda",
        "source": "zoic_tpu_torch/csrc/thinlens.cu",
        "replaces": "zoic_tpu/ops/trace_kernel.py:1381",
        "launches": sum(r["thinlens_launches"] for r in thin.values()),
        "max_abs_err": max(r["max_abs_err"] for r in thin.values()),
        "ms": rep["kernel_ms"],
        "device_ms": rep["device_ms"],
        "plain_ms": rep["plain_ms"],
        "bound_ms": thin_bound[0],
        "bound_by": thin_bound[1],
        "library_ms": None,
        "config": "thinlens_f1.4",
    }, {
        "name": "bokeh",
        "route": "cuda",
        "source": "zoic_tpu_torch/csrc/bokeh.cu",
        "replaces": "zoic_tpu/ops/bokeh_kernel.py:101",
        "launches": (sum(r["bokeh_launches"] for r in thin.values())
                     + sum(r["bokeh_launches"] for r in rt.values())),
        "max_abs_err": bk["max_abs_err"],
        "ms": bk["kernel_ms"],
        "device_ms": bk["device_ms"],
        "plain_ms": bk["plain_ms"],
        "bound_ms": bokeh_bound[0],
        "bound_by": bokeh_bound[1],
        "library_ms": None,
    }, {
        "name": "roofline",
        "route": "cuda",
        "source": "zoic_tpu_torch/csrc/roofline.cu",
        "replaces": "tools/roofline.py:83",
        "launches": bn["launches"],
        "max_abs_err": roof["max_abs_err"],
        "ms": roof["ms"],
        "device_ms": roof["device_ms"],
        "plain_ms": roof["plain_ms"],
        "bound_ms": roof["bound_ms"],
        "bound_by": roof["bound_by"],
        "library_ms": None,
        "config": "fma",
        "contract_ms": roof["contract_ms"],
    }]
    check(rt["raytraced_bokeh_image"]["bokeh_launches"] > 0
          and entries[2]["launches"] > 0,
          "the bokeh configs launched no bokeh kernel")

    print("[27 compile and roofline summary] " + json.dumps({
        "compile_s": {n: r["compile_s"] for n, r in comp.items()},
        "mc_statics_equal": {n: r["mc_statics_equal"]
                             for n, r in comp.items()},
        "roofline_top_s": {n: r["rate"] / 1e12
                           for n, r in roof["rows"].items()},
        "roofline_bound_share": {n: r["bound_ms"] / r["ms"]
                                 for n, r in roof["rows"].items()},
        "fma_contract_top_s": roof["contract_rate"] / 1e12,
        "lanes_per_warp_trace": {n: r["lanes_per_warp_trace"]
                                 for n, r in lanes.items()
                                 if "lanes_per_warp_trace" in r},
    }), flush=True)
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    sys.exit(main())
