"""Every device operation of one ``create_rays`` call, by name.

For each camera, ``zoic_tpu_torch.create_rays`` on fixed draws at the
benchmark's batch: one warm-up call, then a torch.profiler window (device
activity only) of ``--calls`` calls, opened with a short
``torch.cuda._sleep`` kernel and a synchronise whose record is dropped (late
in a process the profiler can lose a window's first records); a window
in which a name kept no whole multiple of the calls' records is taken
again, up to three windows.  Per operation name: records per call and
device µs per call (a name's records over the calls, its µs summed over
them and over the calls); then the call's time by CUDA events (median of 10, 3
warm-up).  The cameras: the headline (its shipped state) and the
benchmark's thin-lens f/1.4 with and without empirical vignetting
(``compile_camera``), and the headline with image bokeh (its shipped
state: the sampler and the retry planes' entry before the raytraced
kernel).  It calls only the public entry points, so a copy
of it runs in an older tree of the port too, to list the operations
before a change.

    python -m zoic_tpu_torch.tools.create_rays_ops [--batch 4194304]
        [--calls 5] [--camera NAME ...]

One line per camera and operation, then one JSON line of everything.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch

import zoic_tpu_torch as zt

SEED = 20261016
PRIMER = "spin_kernel"
PRIMER_CYCLES = 1000
CAMERAS = ("headline", "thinlens_f1.4", "thinlens_vignette",
           "raytraced_bokeh_image")
# the cameras whose state is shipped (zoic_tpu_torch/data)
SHIPPED = ("headline", "raytraced_bokeh_image")


def config(name: str):
    """The camera's config, max_tries 25."""
    if name in SHIPPED:
        cam = zt.data.CAMERAS[name]
        # the shipped state holds the bokeh image: the path is not read
        image = {"bokeh_path": "disk64.npy"} if cam.use_image else {}
        return zt.CameraConfig(lens_model=zt.LensModel.RAYTRACED,
                               lens_data_path=zt.data.lens_path(cam.lens),
                               max_tries=25, **cam.config_kwargs(), **image)
    vig = (dict(optical_vignetting_distance=1.0,
                optical_vignetting_radius=1.0)
           if name == "thinlens_vignette" else {})
    return zt.CameraConfig(lens_model=zt.LensModel.THINLENS, focal_length=5.0,
                           fstop=1.4, focal_distance=100.0, max_tries=25,
                           use_dof=True, **vig)


def state(name: str, cfg, dev):
    if name in SHIPPED:
        return zt.load_state(zt.data.state_path(zt.data.CAMERAS[name].file),
                             device=dev)
    return zt.compile_camera(cfg, dev)


def operations(fn, calls: int, windows: int = 3):
    """``({name: [records per call, device µs per call]}, whole)`` over a
    profiler window of ``calls`` calls of ``fn()``: the first window in
    which every name kept a whole multiple of ``calls`` records (``whole``
    True), else the last of ``windows`` (the profiler lost records)."""
    fn()
    torch.cuda.synchronize()
    for _ in range(windows):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(PRIMER_CYCLES)
            torch.cuda.synchronize()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        records: dict = {}
        for e in prof.events():
            if (e.device_type != torch.autograd.DeviceType.CUDA
                    or e.device_time_total <= 0 or PRIMER in e.name):
                continue
            records.setdefault(e.name, []).append(e.device_time_total)
        whole = all(len(us) % calls == 0 for us in records.values())
        if whole:
            break
    ops = {name: [len(us) / calls, sum(us) / calls]
           for name, us in records.items()}
    return dict(sorted(ops.items(), key=lambda kv: -kv[1][1])), whole


def events_ms(fn, warmup: int = 3, iters: int = 10) -> float:
    times = []
    for it in range(warmup + iters):
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        if it >= warmup:
            times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4_194_304)
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--camera", nargs="*", default=list(CAMERAS),
                    choices=CAMERAS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("create_rays_ops needs a CUDA card")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    out = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "package": zt.__file__, "batch": args.batch, "cameras": {}}
    for name in args.camera:
        cfg = config(name)
        st = state(name, cfg, dev)
        g = torch.Generator(device=dev).manual_seed(SEED)
        sx, sy = (torch.rand(args.batch, generator=g, device=dev) * 2 - 1
                  for _ in range(2))
        lx, ly = (torch.rand(args.batch, generator=g, device=dev)
                  for _ in range(2))

        def call():
            return zt.create_rays(st, cfg, sx, sy, lx, ly, seed=SEED % 4096)

        ops, whole = operations(call, args.calls)
        ms = events_ms(call)
        total = sum(us for _, us in ops.values())
        n_ops = sum(n for n, _ in ops.values())
        out["cameras"][name] = {"events_ms": ms, "device_us": total,
                                "operations": n_ops, "whole": whole,
                                "by_name": ops}
        print(f"[{name}] B = {args.batch}, on {smi}: create_rays {ms:.4f} ms "
              f"(CUDA events, median of 10); {n_ops:.1f} device operations "
              f"a call, {total:.1f} us on the card (profiler, "
              f"{args.calls} calls; "
              + ("every record kept" if whole else "records lost: counts "
                 "and us are of the records kept") + ")", flush=True)
        for op, (n, us) in ops.items():
            print(f"[{name}]   {n:4.1f} x {us:9.1f} us  {op[:110]}",
                  flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
