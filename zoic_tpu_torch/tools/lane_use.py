"""Lane use of the camera kernels: how full the warps are when they trace.

A warp runs an instruction for all its 32 lanes whether one or all of them
need it, so a retry walk pays for idle lanes.  The camera kernels' counting
builds (``ZOIC_COUNT_LANES``) add up, at the entry of every element-stack
trace and every aperture draw, the lanes that are active and the converged
groups of a warp that they form.  This tool runs them at the benchmark's
batch on five raytraced cameras (the headline, naive shaping, the fisheye,
the telephoto at focus 100 cm and the Petzval at focus 1000 cm) and on the
thin-lens camera with vignetting, and prints per camera one line and at the
end one JSON line:

* ``traces_per_ray`` and ``draws_per_ray``: the work the rays need;
* ``warp_traces_per_warp``: trace passes a warp of 32 rays pays for;
* ``lanes_per_warp_trace`` (and ``lanes_per_warp_draw``): mean active
  lanes, of 32;
* ``device_ms``: the main build's time per launch, CUDA events around a
  bare loop of launches on the same inputs;
* ``equal``: the counting build's ``tries``/``tir`` equal the main
  build's on every ray (for the thin lens, every output of
  ``thinlens_rays``: its warps take tiles of 128 rays, four a lane, so a
  warp's attempts are those of four groups of 32 rays).

    python -m zoic_tpu_torch.tools.lane_use [--batch 4194304] [--seed 7]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

import zoic_tpu_torch as zt
from zoic_tpu_torch.models import raytraced as rt_model
from zoic_tpu_torch.ops import trace_kernel

RAYTRACED = ("headline", "raytraced_naive", "raytraced_fisheye",
             "raytraced_telephoto_f5.0_focus100",
             "raytraced_petzval_f1.25_focus1000")
MAX_TRIES = 25
LAUNCHES = 10


def device_ms(fn, n: int = LAUNCHES) -> float:
    """Milliseconds per call of ``fn()`` over ``n`` back-to-back calls
    between two CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / n


def draws(b: int, seed: int, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    sx = torch.rand(b, generator=g, device=dev) * 2.0 - 1.0
    sy = torch.rand(b, generator=g, device=dev) * 2.0 - 1.0
    return sx, sy, torch.rand(b, generator=g, device=dev), torch.rand(
        b, generator=g, device=dev)


def raytraced_row(name: str, b: int, seed: int, dev) -> dict:
    cam = zt.data.CAMERAS[name]
    cfg = zt.CameraConfig(
        lens_model=zt.LensModel.RAYTRACED,
        lens_data_path=zt.data.lens_path(cam.lens),
        **dict(cam.config_kwargs(), max_tries=MAX_TRIES))
    state = zt.load_state(zt.data.state_path(name), device=dev)
    sx, sy, lx, ly = draws(b, seed, dev)
    u1, u2, kw = rt_model.kernel_inputs(state, cfg, lx, ly, seed)
    args = (state.lens, sx, sy, u1, u2, state.sensor_width, seed)
    out, n = trace_kernel.raytraced_lane_use(*args, **kw)
    ref = trace_kernel.raytraced_fused(*args, **kw)
    equal = bool(torch.equal(out[2], ref[2]) and torch.equal(out[3], ref[3]))
    warps = -(-b // 32)
    return {
        "traces_per_ray": n["traces"] / b,
        "draws_per_ray": n["draws"] / b,
        "warp_traces_per_warp": n["warp_traces"] / warps,
        "lanes_per_warp_trace": n["traces"] / max(1, n["warp_traces"]),
        "lanes_per_warp_draw": n["draws"] / max(1, n["warp_draws"]),
        "device_ms": device_ms(
            lambda: trace_kernel.raytraced_fused(*args, **kw)),
        "equal": equal,
    }


def thinlens_row(b: int, seed: int, dev) -> dict:
    cfg = zt.CameraConfig(
        lens_model=zt.LensModel.THINLENS, focal_length=5.0, fstop=1.4,
        focal_distance=100.0, max_tries=MAX_TRIES, use_dof=True,
        optical_vignetting_distance=1.0, optical_vignetting_radius=1.0)
    st = zt.compile_camera(cfg, dev)
    sx, sy, lx, ly = draws(b, seed, dev)
    args = (sx, sy, lx, ly, st.tan_fov, st.aperture_radius,
            st.focal_distance, st.ov_distance, st.ov_radius, seed,
            st.exposure_control)
    kw = dict(use_dof=True, has_ov=True, max_tries=MAX_TRIES)
    out, n = trace_kernel.thinlens_lane_use(*args, **kw)
    ref = trace_kernel.thinlens_rays(*args, **kw)
    warps = -(-b // 32)
    return {
        "attempts_per_ray": n["attempts"] / b,
        "warp_attempts_per_warp": n["warp_attempts"] / warps,
        "lanes_per_warp_attempt": n["attempts"] / max(1, n["warp_attempts"]),
        "device_ms": device_ms(
            lambda: trace_kernel.thinlens_rays(*args, **kw)),
        "equal": all(torch.equal(a, r) for a, r in zip(out, ref)),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4_194_304)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("lane_use needs a CUDA card: the counting builds "
                         "have no CPU mode")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    rows = {}
    for name in RAYTRACED:
        rows[name] = raytraced_row(name, args.batch, args.seed, dev)
    rows["thinlens_vignette"] = thinlens_row(args.batch, args.seed, dev)
    for name, r in rows.items():
        print(f"[lane use] {name}, B = {args.batch}, on {smi}: " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in r.items()), file=sys.stderr, flush=True)
    print(json.dumps({"card": smi, "batch": args.batch, "lane_use": rows}))
    return 0 if all(r["equal"] for r in rows.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
