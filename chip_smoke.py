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
  without the pre-check.

    python3 chip_smoke.py

Phases, one line each: the device; the kernel builds (three ``nvcc`` runs
in parallel); then per camera the run through ``create_rays`` checked for
launches, finite outputs and its run counters, the kernel against its
plain PyTorch version on the same inputs, and timings with CUDA events;
the bokeh kernel against its plain version on 4,194,304 draws
(bit-equal).  Then one JSON line per the kernel table, the card's name
and power limit from nvidia-smi, and last ``{"ok": true, "device":
...}``.  Any failed check exits non-zero before the last line.  It needs
a CUDA card and ``nvcc``, and imports nothing of jax.
"""

from __future__ import annotations

import json
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
KERNELS = ("raytraced", "thinlens", "bokeh")
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
        lens_data_path=os.path.join("zoic_tpu", "data", "lenses",
                                    f"{cam.lens}.dat"),
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


def reset_counts(trace_kernel, bokeh_kernel) -> None:
    trace_kernel.launches = 0
    trace_kernel.thinlens_launches = 0
    bokeh_kernel.launches = 0


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
          + median_line(timed), flush=True)
    return {"launches": n_launch, "bokeh_launches": n_bokeh,
            "max_abs_err": max_abs_err, "mismatches": mismatch,
            "attempts": attempts, "vignetted_frac": vig_frac,
            "kernel_ms": statistics.median(timed["kernel"]),
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
    print(f"[{tag}c {name} timing] median of 10 (3 warm-up), B = {BATCH}, "
          f"on {smi}: " + median_line(timed), flush=True)
    return {"thinlens_launches": n_thin, "bokeh_launches": n_bokeh,
            "max_abs_err": err,
            "kernel_ms": statistics.median(timed["kernel"]),
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
    print(f"[{tag}b bokeh timing] median of 10 (3 warm-up), B = {BATCH} "
          f"draws, on {smi}: " + median_line(timed).replace("rays/s",
                                                            "draws/s"),
          flush=True)
    return {"max_abs_err": err,
            "kernel_ms": statistics.median(timed["kernel"]),
            "plain_ms": statistics.median(timed["plain"])}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke FAILED: torch.cuda.is_available() is "
                         "False; this smoke test needs a CUDA card")
    import zoic_tpu_torch as zt
    from zoic_tpu_torch.ops import _build, bokeh_kernel, trace_kernel

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    print(f"[1 device] {kind} | nvidia-smi: {smi} | torch {torch.__version__}"
          f" cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    _build.load_all(KERNELS)
    print(f"[2 build] csrc/{{{','.join(KERNELS)}}}.cu for sm_90a in "
          f"{time.perf_counter() - t0:.2f} s (parallel nvcc)", flush=True)

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
        name: {k: r[k] for k in ("kernel_ms", "plain_ms", "create_rays_ms",
                                 "attempts", "vignetted_frac", "mismatches")}
        for name, r in rt.items()}), flush=True)

    rep = thin["thinlens_f1.4"]
    entries = [{
        "name": "raytraced",
        "route": "cuda",
        "source": "zoic_tpu_torch/csrc/raytraced.cu",
        "replaces": "zoic_tpu/ops/trace_kernel.py:975",
        "launches": sum(r["launches"] for r in rt.values()),
        "max_abs_err": max(r["max_abs_err"] for r in rt.values()),
        "ms": head["kernel_ms"],
        "plain_ms": head["plain_ms"],
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
        "plain_ms": rep["plain_ms"],
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
        "plain_ms": bk["plain_ms"],
    }]
    check(rt["raytraced_bokeh_image"]["bokeh_launches"] > 0
          and entries[-1]["launches"] > 0,
          "the bokeh configs launched no bokeh kernel")

    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    sys.exit(main())
