"""Benchmark: camera rays per second on one card, the port's ``bench.py``.

    python -m zoic_tpu_torch.bench [--batch 4194304] [--iters 7] [--inner 32]
        [--all] [--only NAMES] [--random-order] [--max-tries N]
        [--no-precheck] [--mesh] [--device cuda]

Each camera is compiled by the port from its lens file
(:func:`zoic_tpu_torch.compile_camera`, seconds reported).  The headline is
the raytraced Double Gauss f/2.0 (focal length 5 cm, focus 100 cm,
exit-pupil LUT and pupil pre-check on); ``--all`` adds ``bench.py``'s
eleven other cameras (three thin-lens ones, the fisheye, the headline with image
bokeh from a 64x64 disk, and the Petzval f/1.25 and telephoto f/5 at focus
30, 100 and 1000 cm), one stderr line each.  The headline prints ONE JSON
line with ``bench.py``'s keys: ``metric``, ``value`` (rays/s),
``unit``, ``vs_baseline`` (value / 1e9, ``bench.py``'s definition),
``attempts_per_ray``, ``vignetted_frac``, ``peak_tops`` and ``mfu``, plus
``device``, the card it ran on.  ``--mesh`` splits the headline's batch
over every visible card (:mod:`zoic_tpu_torch.parallel.sharding`); on more
than one the metric is ``camera_rays_per_sec_mesh{n}_double_gauss`` and
``vs_baseline`` is per card, as in ``bench.py``.

Method: screen samples in raster order (a renderer's bucket order), fixed;
lens samples fresh every generation, drawn with ``torch.rand`` on the
card's generator inside the timed window, as ``bench.py`` draws inside its
step (one generator per card of the mesh); a retry seed per generation
from a host generator.  Every output is
consumed (``sum(weight) + sum(dir[:, 0])``).  A burst of ``iters`` steps of
``inner`` generations is timed between two CUDA events; the rate is the
median of 3 bursts after warm-up, and attempts/ray and the vignetted
fraction come from the timed loop's own ``RayStats``.

``peak_tops`` is the card's element-op rate, the highest of the f32
``fma``, ``mul`` and ``add`` chains that the op-rate microbenchmark
(:mod:`zoic_tpu_torch.tools.roofline`) measures at start-up; ``mfu`` is
``rays/s * USEFUL_OPS_PER_RAY / peak``.  The work count is ``bench.py``'s
cost model of the algorithm's element-ops per ray, not a speed, so the two
packages' ``mfu`` read the same work; a ``benchmark`` change owns it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

import zoic_tpu_torch as zt
from zoic_tpu_torch.optics import div
from zoic_tpu_torch.parallel import sharding
from zoic_tpu_torch.tools import roofline

# bench.py's work count: ~560 element-ops per traced attempt x ~1.22
# traced attempts + ~72 ops x ~0.9 pre-check-consumed draws per ray
USEFUL_OPS_PER_RAY = 560 * 1.22 + 72 * 0.9
BASELINE_RAYS_PER_SEC = 1e9  # vs_baseline's denominator (bench.py)
METRIC = "camera_rays_per_sec_chip_double_gauss_f2.0_lut"
MESH_METRIC = "camera_rays_per_sec_mesh{n}_double_gauss"
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def screen_samples(n: int, device, raster: bool = True, seed: int = 0):
    """Screen samples ``(sx, sy)`` in [-1, 1]: image-raster order
    (``bench.py:_samples``), or uniform draws in shuffled order."""
    if raster:
        side = int(n**0.5)
        while n % side:
            side -= 1
        ny, nx = side, n // side
        f = torch.float32
        ys = div(torch.arange(ny, dtype=f, device=device) + 0.5, ny) * 2.0 - 1.0
        xs = div(torch.arange(nx, dtype=f, device=device) + 0.5, nx) * 2.0 - 1.0
        return xs.repeat(ny), ys.repeat_interleave(nx)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    v = torch.rand((2, n), generator=g, device=device)
    return v[0] * 2.0 - 1.0, v[1] * 2.0 - 1.0


def bench_config(cfg: zt.CameraConfig, n: int, iters: int, inner: int = 16,
                 warmup: int = 2, raster: bool = True, device="cuda",
                 mesh: sharding.Mesh = None) -> dict:
    """Compile ``cfg`` on ``device`` and time ``create_rays`` at batch
    ``n``, or, with a ``mesh``, the batch split over its devices (compiled
    on the first).  Returns rays/s, attempts/ray, the vignetted fraction
    and the compile's seconds."""
    devs = (torch.device(device),) if mesh is None else mesh.devices
    dev = devs[0]
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            for d in set(devs):
                torch.cuda.synchronize(d)

    t0 = time.perf_counter()
    state = zt.compile_camera(cfg, dev)
    sync()
    compile_s = time.perf_counter() - t0
    if n % len(devs):
        raise ValueError(f"batch {n} not divisible by mesh size {len(devs)}")
    per = n // len(devs)
    sx, sy = screen_samples(n, dev, raster=raster)
    if mesh is not None:
        sx, sy = sharding.shard_samples(mesh, sx, sy)
    # lens samples from each card's generator (torch.rand, a few fused
    # launches); bench.py's murmur3 draws were chosen for the TPU's
    # threefry cost, and the port's hash_uniform is an eager int64 chain of
    # some 40 launches that would time the sampler, not the camera
    gens = [torch.Generator(device=d).manual_seed(42 + k)
            for k, d in enumerate(devs)]
    seeds = torch.randint(0, 1 << 22, ((warmup + 3 * iters) * inner,),
                          generator=torch.Generator().manual_seed(42)).tolist()

    def draws():
        return [torch.rand(per, generator=g, device=d)
                for g, d in zip(gens, devs)]

    def step(k):
        acc = torch.zeros((), dtype=torch.float32, device=dev)
        vig = torch.zeros((), dtype=torch.int64, device=dev)
        tri = torch.zeros((), dtype=torch.int64, device=dev)
        for i in range(inner):
            seed = seeds[k * inner + i]
            # consume the outputs, as bench.py does; without --mesh no
            # detour through the mesh: the loop is host-bound, and a mesh of
            # one card cost the headline 11% (NVIDIA H100 80GB HBM3, 700 W)
            if mesh is None:
                u1 = torch.rand(n, generator=gens[0], device=dev)
                u2 = torch.rand(n, generator=gens[0], device=dev)
                rays, stats = zt.create_rays(state, cfg, sx, sy, u1, u2,
                                             seed=seed)
                acc = acc + rays.weight.sum() + rays.dir[:, 0].sum()
                vig = vig + stats.vignetted
                tri = tri + stats.tries_total
                continue
            for rays, stats in sharding.create_rays_shards(
                    mesh, state, cfg, sx, sy, draws(), draws(), seed=seed):
                acc = acc + (rays.weight.sum() + rays.dir[:, 0].sum()).to(dev)
                vig = vig + stats.vignetted.to(dev)
                tri = tri + stats.tries_total.to(dev)
        return acc, vig, tri

    for k in range(warmup):
        step(k)
    sync()
    rates = []
    vig_sum = tries_sum = 0
    for rep in range(3):
        outs = []
        if cuda:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
        start = time.perf_counter()
        for i in range(iters):
            outs.append(step(warmup + rep * iters + i))
        if cuda:
            # the sums gathered on the first card wait for every card
            e1.record()
            e1.synchronize()
            dt = e0.elapsed_time(e1) / 1e3
        else:
            dt = time.perf_counter() - start
        rates.append(inner * n * iters / dt)
        vig_sum += sum(int(o[1]) for o in outs)
        tries_sum += sum(int(o[2]) for o in outs)
    total = 3 * iters * inner * n
    return {
        "rays_per_sec": statistics.median(rates),
        "vignetted_frac": vig_sum / total,
        "attempts_per_ray": 1.0 + tries_sum / total,
        "compile_s": compile_s,
    }


def configs(bokeh_path: str) -> dict:
    """The headline and ``bench.py``'s eleven other cameras
    (``bench.py:236-304``), each compiled from the port's lens files."""
    dg = zt.data.lens_path("double_gauss_f2.0")
    thin = dict(lens_model=zt.LensModel.THINLENS, focal_length=5.0, fstop=1.4,
                focal_distance=100.0, use_dof=True)
    out = {
        "headline": zt.CameraConfig(
            lens_model=zt.LensModel.RAYTRACED, lens_data_path=dg,
            focal_length=5.0, fstop=2.0, focal_distance=100.0,
            kolb_sampling_lut=True),
        "thinlens_f1.4": zt.CameraConfig(**thin),
        "thinlens_vignette": zt.CameraConfig(
            **thin, optical_vignetting_distance=1.0,
            optical_vignetting_radius=1.0),
        "thinlens_bokeh_image": zt.CameraConfig(
            **thin, use_image=True, bokeh_path=bokeh_path),
        "raytraced_fisheye": zt.CameraConfig(
            lens_model=zt.LensModel.RAYTRACED,
            lens_data_path=zt.data.lens_path("fisheye_muller_f4.0"),
            focal_length=1.0, fstop=4.0, focal_distance=100.0),
        "raytraced_bokeh_image": zt.CameraConfig(
            lens_model=zt.LensModel.RAYTRACED, lens_data_path=dg,
            focal_length=5.0, fstop=2.0, focal_distance=100.0,
            kolb_sampling_lut=True, use_image=True, bokeh_path=bokeh_path),
    }
    # focus breathing: each distance is a fresh image-distance solve
    for lens_name, focal, fstop in (("petzval_f1.25", 5.0, 1.25),
                                    ("telephoto_f5.0", 10.0, 5.0)):
        for focus in (30.0, 100.0, 1000.0):
            out[f"raytraced_{lens_name}_focus{focus:g}"] = zt.CameraConfig(
                lens_model=zt.LensModel.RAYTRACED,
                lens_data_path=zt.data.lens_path(lens_name),
                focal_length=focal, fstop=fstop, focal_distance=focus)
    return out


def write_bokeh_disk(root: str = os.path.join(_REPO, "build", "bench")) -> str:
    """The benchmark's 64x64 disk bokeh image as an ``.npy`` under
    ``root``."""
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, "bokeh_disk64.npy")
    np.save(path, zt.data.bokeh_disk(64))
    return path


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=1 << 22)
    ap.add_argument("--iters", type=int, default=7)
    ap.add_argument("--inner", type=int, default=32)
    ap.add_argument("--random-order", action="store_true",
                    help="shuffled sample order instead of raster order")
    ap.add_argument("--mesh", action="store_true",
                    help="split the headline's batch over every card")
    ap.add_argument("--all", action="store_true",
                    help="run all the benchmark's cameras")
    ap.add_argument("--only", type=str, default="",
                    help="with --all: comma list of substrings; run only "
                         "matching extra cameras (skips the headline too "
                         "unless 'headline' matches)")
    ap.add_argument("--max-tries", type=int, default=None,
                    help="override the headline's retry budget")
    ap.add_argument("--no-precheck", action="store_true",
                    help="disable the headline's pupil pre-check")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.only:
        args.all = True  # --only filters the --all table
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench: no CUDA card; pass --device cpu to run the "
                         "plain versions on the CPU")
    device_name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu")

    cams = configs(write_bokeh_disk())
    headline = cams.pop("headline")
    over = {}
    if args.max_tries is not None:
        over["max_tries"] = args.max_tries
    if args.no_precheck:
        over["pupil_precheck"] = False
    headline = dataclasses.replace(headline, **over)

    peak, rates = roofline.peak_ops(dev)
    print(f"  peak element-op rate on {device_name}: "
          + ", ".join(f"{k} {v / 1e12:.3f}" for k, v in rates.items())
          + " Top/s", file=sys.stderr)

    if args.all:
        for name, cfg in cams.items():
            if args.only and not any(s in name for s in args.only.split(",")):
                continue
            r = bench_config(cfg, args.batch, args.iters, args.inner,
                             device=dev)
            print(f"  {name}: {r['rays_per_sec']:.3e} rays/s (vignetted "
                  f"{r['vignetted_frac']:.6f}, {r['attempts_per_ray']:.6f} "
                  f"attempts/ray, mfu "
                  f"{r['rays_per_sec'] * USEFUL_OPS_PER_RAY / peak:.4f}, "
                  f"compile {r['compile_s']:.2f} s)", file=sys.stderr)

    if args.only and "headline" not in args.only:
        return
    mesh = None
    if args.mesh:
        mesh = (sharding.make_mesh() if dev.type == "cuda"
                else sharding.make_mesh([dev]))
    n_dev = 1 if mesh is None else mesh.size
    res = bench_config(headline, args.batch, args.iters, args.inner,
                       raster=not args.random_order, device=dev, mesh=mesh)
    print(f"  headline: compile {res['compile_s']:.2f} s", file=sys.stderr)
    print(json.dumps({
        "metric": METRIC if n_dev == 1 else MESH_METRIC.format(n=n_dev),
        "value": res["rays_per_sec"],
        "unit": "rays/sec",
        "vs_baseline": res["rays_per_sec"] / n_dev / BASELINE_RAYS_PER_SEC,
        "attempts_per_ray": res["attempts_per_ray"],
        "vignetted_frac": res["vignetted_frac"],
        "peak_tops": peak / 1e12,
        "mfu": res["rays_per_sec"] * USEFUL_OPS_PER_RAY / peak,
        "device": device_name,
    }), flush=True)


if __name__ == "__main__":
    main()
