"""Smoke test of the PyTorch port on one CUDA card.

Drives the port's main path once at the benchmark's batch (4,194,304 rays):
the raytraced Double Gauss camera (focal length 5 cm, f/2, focus 100 cm,
exit-pupil LUT and pupil pre-check on, max_tries 25) through
``zoic_tpu_torch.create_rays`` on the compiled state shipped with the port.

    python3 chip_smoke.py

Phases, one line each: the device; the kernel build; the inputs; the main
path run, checked for launches, finite outputs and its run counters; the
kernel against its plain PyTorch version on the same inputs; timings with
CUDA events.  Then one JSON line per the kernel table, the card's name and
power limit from nvidia-smi, and last ``{"ok": true, "device": ...}``.
Any failed check exits non-zero before the last line.  It needs a CUDA
card and ``nvcc``, and imports nothing of jax.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import torch

BATCH = 4_194_304
MAX_TRIES = 25
SEED = 20261016
# kernel vs plain: tries/tir may differ on at most 0.01% of rays (borderline
# compares under a different atan2f build); payloads of rays whose tries
# agree and are live must agree to 1e-5 absolute
MAX_TRIES_MISMATCH = 419
PAYLOAD_ATOL = 1e-5


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


def headline_config(zt):
    return zt.CameraConfig(
        lens_model=zt.LensModel.RAYTRACED,
        lens_data_path=os.path.join(
            "zoic_tpu", "data", "lenses", "double_gauss_f2.0.dat"
        ),
        focal_length=5.0,
        fstop=2.0,
        focal_distance=100.0,
        kolb_sampling_lut=True,
        max_tries=MAX_TRIES,
    )


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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke FAILED: torch.cuda.is_available() is "
                         "False; this smoke test needs a CUDA card")
    import zoic_tpu_torch as zt
    from zoic_tpu_torch.ops import _build, trace_kernel

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    print(f"[1 device] {kind} | nvidia-smi: {smi} | torch {torch.__version__}"
          f" cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    _build.load("raytraced")
    print(f"[2 build] csrc/raytraced.cu for sm_90a in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    state = zt.load_state(zt.data.state_path(), device=dev)
    cfg = headline_config(zt)
    g = torch.Generator(device=dev).manual_seed(SEED)
    sx, sy, lx, ly = draws(g, BATCH, dev)
    print(f"[3 inputs] state {zt.data.HEADLINE} on {dev}, {state.lens.count} "
          f"elements; B = {BATCH} draws from torch.Generator seed {SEED}",
          flush=True)

    # ---- main path through the public entry point
    trace_kernel.launches = 0
    rays, stats = zt.create_rays(state, cfg, sx, sy, lx, ly, generator=g)
    torch.cuda.synchronize()
    n_launch = trace_kernel.launches
    check(n_launch > 0, "the main path launched no raytraced kernel")
    for name in ("origin", "dir", "weight", "d_ody", "d_ddy"):
        t = getattr(rays, name)
        check(t.is_cuda, f"rays.{name} is not on cuda")
        check(bool(torch.isfinite(t).all()), f"rays.{name} is not finite")
    check(rays.origin.shape == (BATCH, 3) and rays.dir.shape == (BATCH, 3),
          "unexpected output shapes")
    success, vig = int(stats.success), int(stats.vignetted)
    check(success + vig == BATCH, f"success {success} + vignetted {vig} != B")
    attempts = 1.0 + int(stats.tries_total) / BATCH
    check(1.0 <= attempts <= 3.0, f"attempts/ray {attempts} outside [1, 3]")
    vig_frac = vig / BATCH
    check(vig_frac < 0.01, f"vignetted fraction {vig_frac} >= 1%")
    live = rays.weight > 0
    norm_err = float((rays.dir[live].norm(dim=1) - 1.0).abs().max())
    check(norm_err < 1e-4, f"live ray directions not unit: {norm_err}")
    print(f"[4 main path] launches {n_launch}; success {success} vignetted "
          f"{vig} tir {int(stats.tir)}; attempts/ray {attempts:.6f}; "
          f"vignetted frac {vig_frac:.3e}; max ||dir|-1| {norm_err:.2e}",
          flush=True)

    # ---- kernel vs its plain version on the same inputs and seed
    seed = SEED % (1 << 22)
    args = (state.lens, sx, sy, lx, ly, state.sensor_width, seed)
    ko, kd, kt, ktir = trace_kernel.raytraced_fused(*args, max_tries=MAX_TRIES)
    po, pd, pt, ptir = trace_kernel.raytraced_plain(*args, max_tries=MAX_TRIES)
    torch.cuda.synchronize()
    mismatch = int(((kt != pt) | (ktir != ptir)).sum())
    same = (kt == pt) & (ktir == ptir) & (kt <= MAX_TRIES)
    err_o = float((ko - po)[same].abs().max())
    err_d = float((kd - pd)[same].abs().max())
    err_all = max(float((ko - po).abs().max()), float((kd - pd).abs().max()))
    max_abs_err = max(err_o, err_d)
    print(f"[5 kernel vs plain] tries/tir mismatches {mismatch} of {BATCH} "
          f"(limit {MAX_TRIES_MISMATCH}); live max |d origin| {err_o:.3e} "
          f"|d dir| {err_d:.3e} (limit {PAYLOAD_ATOL}); all rays "
          f"{err_all:.3e}", flush=True)
    check(mismatch <= MAX_TRIES_MISMATCH, "kernel and plain disagree on tries")
    check(max_abs_err <= PAYLOAD_ATOL, "kernel and plain payloads disagree")

    # ---- timings (information only)
    tg = torch.Generator(device=dev).manual_seed(SEED + 1)

    def fresh():
        s = int(torch.randint(0, 1 << 22, (), generator=tg, device=dev))
        return (state.lens, *draws(tg, BATCH, dev), state.sensor_width, s)

    def kernel(*a):
        trace_kernel.raytraced_fused(*a, max_tries=MAX_TRIES)

    def plain(*a):
        trace_kernel.raytraced_plain(*a, max_tries=MAX_TRIES)

    def end_to_end(lens, *a):
        zt.create_rays(state, cfg, *a[:4], seed=a[5])

    timed = {name: time_ms(fn, fresh) for name, fn in
             (("kernel", kernel), ("plain", plain),
              ("create_rays", end_to_end))}
    parts = []
    for name, ts in timed.items():
        med = statistics.median(ts)
        parts.append(f"{name} {med:.4f} ms = {BATCH / med / 1e3:.1f} M "
                     f"rays/s (min {min(ts):.4f}, max {max(ts):.4f})")
    print(f"[6 timing] median of 10 (3 warm-up), B = {BATCH}, on {smi}: "
          + "; ".join(parts), flush=True)
    k_ms = statistics.median(timed["kernel"])
    p_ms = statistics.median(timed["plain"])

    print(json.dumps({"kernels": [{
        "name": "raytraced",
        "route": "cuda",
        "source": "zoic_tpu_torch/csrc/raytraced.cu",
        "replaces": "zoic_tpu/ops/trace_kernel.py:975",
        "launches": n_launch,
        "max_abs_err": max_abs_err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    sys.exit(main())
