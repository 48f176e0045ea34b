#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once, on the card, and print its
result as the last line of standard output.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up makes everything from ``--seed`` (samples, the lens compile's
draws, retry seeds; the bokeh image is fixed), builds the camera
(``zoic_tpu_torch.Camera``), warms up the cell's shapes, and measures for
``--seconds``.  ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics from a profiled window after the
measured one.  Both then compare the calls the window kept with the plain
reference (``core/check.py``).  Without a card (or with fewer than the
cell asks for) the run fails and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402


def _since_process_start() -> float:
    """Seconds from the process's start to now, from ``/proc`` (0 where
    that cannot be read)."""
    try:
        with open("/proc/self/stat") as f:
            start = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


BEFORE_START = _since_process_start()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

# names whose presence in sys.modules after the window refuses the run,
# compared by whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "zoic_tpu")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("bf16",), default=None,
                    help="judge the reference in bfloat16 in the program's "
                         "place (the control of the comparison)")
    return ap.parse_args(argv)


def camera_config(zt, cam, lens_path, bokeh_path):
    """The port's ``CameraConfig`` of a configuration's camera fields."""
    keys = ("sensor_width", "sensor_height", "focal_length", "fstop",
            "focal_distance", "use_image", "kolb_sampling_lut", "use_dof",
            "optical_vignetting_distance", "optical_vignetting_radius",
            "exposure_control", "max_tries", "pupil_precheck",
            "lut_film_samples", "lut_bounds_samples")
    kw = {k: getattr(cam, k) for k in keys}
    return zt.CameraConfig(
        lens_model=zt.LensModel[cam.lens_model],
        lens_data_path=lens_path or "", bokeh_path=bokeh_path or "", **kw)


def run(args, device="cuda", overrides=None, log=sys.stderr, fault=None,
        spec=None):
    """One run; returns ``(exit code, result dict or None)``.  ``device``,
    ``overrides`` (``{"camera": {...}, "traffic": {...}}``), ``fault`` (a
    function of the camera, applied after set-up) and ``spec`` (in place
    of ``BENCHMARK.json``) serve the CPU tests."""
    import torch

    from benchmark.core import cells, check, drive, inputs, peaks, profile
    from benchmark.reference import camera as ref_camera

    cell = cells.Cell(args.workload, spec)
    overrides = overrides or {}
    cell.config["camera"].update(overrides.get("camera", {}))
    cell.traffic.update(overrides.get("traffic", {}))
    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < cell.chips):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: the cell {cell.name} needs {cell.chips} CUDA "
              f"card(s); this machine has {n}", file=log)
        return 2, None
    dev = torch.device(device)

    import zoic_tpu_torch as zt

    # ---------------------------------------------------------------- set-up
    cam = ref_camera.camera_fields(cell.config["camera"])
    lens_path = (cell.path(f"configs/{cam.lens_file}")
                 if hasattr(cam, "lens_file") else None)
    bokeh_pixels = bokeh_path = None
    if cam.use_image:
        bokeh_pixels = inputs.bokeh_disk(cam.bokeh_disk)
        bokeh_path = inputs.write_image(
            bokeh_pixels, os.path.join(ROOT, "build", "benchmark",
                                       f"bokeh_disk{cam.bokeh_disk}.npy"))
    config = camera_config(zt, cam, lens_path, bokeh_path)
    uniforms = None
    if cam.lens_model == "RAYTRACED":
        uniforms = inputs.compile_uniforms(ref_camera.uniform_shapes(cam),
                                           cell.config["compile_seed"], dev)
    camera = zt.Camera(config, dev, uniforms=uniforms)
    frames, sizes = inputs.make_frames(cell.traffic, args.seed, dev)
    driver = drive.Driver(camera, cell.traffic, frames, sizes, args.seed,
                          refocus=lambda f: config.replace(focal_distance=f))
    if fault is not None:
        fault(camera)
    driver.warmup()
    setup_s = time.perf_counter() - T_START + BEFORE_START

    # ---------------------------------------------------------------- window
    keep = drive.Reservoir(cell.traffic["check_calls"], args.seed)
    window = driver.window(args.seconds, keep)
    if device == "cuda":
        torch.cuda.synchronize()
        memory_peak = torch.cuda.max_memory_allocated(dev)
    else:
        memory_peak = 0
    ctx = SimpleNamespace(window=window, setup_s=setup_s, trace=None,
                          traced=None, cam=cam, lens_path=lens_path,
                          count=cells.module("counts", cell.config["count"]),
                          card=peaks.card() if device == "cuda" else "cpu",
                          note=lambda s: print(s, file=log))
    metrics_rows = cell.per_layer if args.trace else cell.end_to_end
    result_device = {
        "platform": "gpu" if device == "cuda" else "cpu",
        "kind": (torch.cuda.get_device_name(dev) if device == "cuda"
                 else "cpu"),
        "count": cell.chips, "memory_peak_bytes": int(memory_peak)}
    breakdown = None
    if args.trace:
        n_traced = cell.traffic["trace_calls"]
        traced = {}
        ctx.trace = profile.record(
            lambda: traced.update(driver.traced(n_traced)))
        ctx.traced = traced
        result_device["busy_s"] = profile.busy_s(ctx.trace)
        result_device["window_s"] = ctx.trace.window_s
        breakdown = profile.breakdown(ctx.trace)
    metrics = {}
    for m in metrics_rows:
        value = cells.module("metrics", m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    ctx.traced = None
    if args.trace:
        traced.clear()

    # ------------------------------------------------------------ the check
    program_lens = camera.state.lens
    image_distance = None
    if program_lens is not None:
        image_distance = float(program_lens.origin_shift)
        prof = program_lens.profile
        print(f"program compile: pre-check "
              f"{prof.kind if prof is not None else None}, polynomial "
              f"{program_lens.profile_poly}, iris skip "
              f"{program_lens.iris_identity}, dead film "
              f"{program_lens.dead_frac}", file=log)
    del camera, driver
    if device == "cuda":
        torch.cuda.empty_cache()
    verdict = check.judge(
        keep.kept, frames, cam, lens_path, uniforms, bokeh_pixels, dev,
        cell.config["limits"], control=args.control, log=log)
    if image_distance is not None and cell.traffic["mode"] != "refocus":
        ref_lens = next(iter(verdict["states"].values())).lens
        print(f"image distance: program {image_distance!r}, reference "
              f"{float(ref_lens.origin_shift)!r}", file=log)
    print(f"window {window['window_s']:.6f} s, {window['calls']} calls, "
          f"{window['rays']} rays; setup {setup_s:.3f} s; reference "
          f"{verdict['reference_s']:.3f} s; card {ctx.card}; "
          f"{'control ' + args.control if args.control else 'program'}",
          file=log)
    if window["update_s"]:
        print("update s a frame: " + " ".join(
            f"{u:.4f}" for u in window["update_s"]), file=log)
    if window["latency_s"]:
        lat = sorted(window["latency_s"])
        print(f"call ms: median {lat[len(lat) // 2] * 1e3:.4f}, max "
              f"{lat[-1] * 1e3:.4f}", file=log)
    for name, c in verdict["compared"].items():
        print(f"{name} {c['value']:.9g} limit {c['limit']:g}", file=log)
    found = forbidden_modules()
    if found:
        print(f"benchmark: the process loaded {', '.join(found)}: the "
              f"benchmark measures zoic_tpu_torch alone", file=log)
        return 3, None
    result = {"correct": verdict["correct"], "attempted": window["calls"],
              "failed": verdict["failed"], "metrics": metrics,
              "device": result_device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = verdict["compared"]
    return 0, result


def main(argv=None) -> int:
    args = parse(argv)
    code, result = run(args)
    if result is not None:
        sys.stdout.flush()
        print(json.dumps(result), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
