"""What bounds the bokeh kernel: its time on the card beside plain device
copies of the same bytes, by grid size and by where its tables live.

``csrc/bokeh.cu`` reads 8 B and writes 8 B a draw, and its retry-plane
entry writes 8 B a cell and reads nothing.  So two device copies of the
draws' uniforms into the outputs move the bytes a sampler launch must
move, and two fills of the planes' outputs write what a plane launch must
write: how far the kernel stands above them is what its table searches
cost.  On the 64x64 disk at the benchmark's batch the tool prints one line
per measurement and at the end one JSON line, each a mean of torch.profiler
device times per call over 10 calls (the sampler's outputs checked
bit-equal to its plain version first):

* ``sample``: the wrapper's launch (tables in shared memory, persistent
  grid); ``grid_<k>_per_sm``: the same with k blocks an SM;
  ``grid_one_step``: as many blocks as give each thread one step of four
  draws (tables loaded by every block);
* ``global``: the global-memory instance on the same image, through the
  plane entry's tables and their guides, at its blocks an SM;
* ``global_512x512``: the sampler at the wrapper's grid on the 512 x 512
  disk of the benchmark's ``dgauss_bokeh.frame`` at its 18,662,400 draws
  (an HD frame at AA 3), which only the global instance takes;
  ``global_512x512_grid_<k>_per_sm``: the same with k blocks an SM (its
  guide steps, grid and blocks per SM in the JSON line);
* ``planes``: the retry-plane entry over the bench's 4 x 524,288 cells
  (checked bit-equal to its plain version first; its guide tables' steps
  and blocks per SM in the JSON line); ``planes_grid_<k>_per_sm``: the
  same with k blocks of 1,024 threads an SM, each copying the tables;
  ``planes_128x128``, ``planes_300x200``: a 128x128 disk (shared memory)
  and 300x200 random pixels (global memory), each checked bit-equal;
* ``copy``, ``copy_512x512``: the sampler's bytes as two device copies,
  at the batch and at 18,662,400 draws; ``fill``: the planes' bytes as two
  fills.

    python -m zoic_tpu_torch.tools.bokeh_bound [--batch 4194304]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

import zoic_tpu_torch as zt
from zoic_tpu_torch.models import raytraced as rt_model
from zoic_tpu_torch.ops import _launch, bokeh_kernel
from zoic_tpu_torch.utils import profiling

CALLS = 10
TRACE_DIR = os.path.join(os.path.dirname(profiling.DEFAULT_TRACE_DIR),
                         "bokeh_bound")


def device_us(fn, calls: int = CALLS, windows: int = 3) -> float:
    """Device microseconds per call of ``fn()``: each kernel's mean over
    the records the profiler kept, times its launches per call; a window
    whose records were all lost is profiled again, up to ``windows``
    times."""
    fn()
    torch.cuda.synchronize()
    for _ in range(windows):
        with profiling.trace(TRACE_DIR) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.device_time_total > 0]
        if events:
            return sum(e.device_time_total / e.count
                       * max(1, round(e.count / calls)) for e in events)
    raise RuntimeError(f"the profiler saw no device time in {windows} "
                       "windows")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=1 << 22)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bokeh_bound: needs a CUDA card")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    b = args.batch
    image = zt.bokeh.build(zt.data.bokeh_disk(64)).to(dev)
    h, w = image.height, image.width
    g = torch.Generator(device=dev).manual_seed(args.seed)
    u1 = torch.rand(b, generator=g, device=dev)
    u2 = torch.rand(b, generator=g, device=dev)
    dx, dy = torch.empty_like(u1), torch.empty_like(u2)
    want = bokeh_kernel.sample_plain(image, u1, u2)
    packed, shared, grid = bokeh_kernel._plan(image, b, False, dev)
    guided = bokeh_kernel._kernel_tables(image, dev, True)
    sample = _launch.bind("bokeh", "zoic_bokeh_launch",
                          bokeh_kernel._SAMPLE_ARGTYPES)
    def per_sm(shared: int, hash_: int, smem: int) -> int:
        return _launch.blocks_per_sm(
            "bokeh", "zoic_bokeh_blocks_per_sm", [ctypes.c_int] * 3, dev,
            shared, hash_, smem)[1]

    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def launch(tables, smem: bool, blocks: int, img=image,
               io=(u1, u2, dx, dy)):
        """The sampler over ``io``'s draws: the packed tables in shared
        memory (``smem``), else PlaneTables ``tables`` with their guides."""
        words, guides = (tables, (0,) * 4) if smem else (tables.words,
                                                         tables[1:])
        _launch.launch(sample, "bokeh", dev, io[0].data_ptr(),
                       io[1].data_ptr(), words.data_ptr(), io[2].data_ptr(),
                       io[3].data_ptr(), io[0].numel(), img.height,
                       img.width, words.numel(), *guides, int(smem), blocks)

    def timed(label, fn, out=(dx, dy), ref=want):
        fn()
        torch.cuda.synchronize()
        for got, r in zip(out, ref):
            if not torch.equal(got.view(torch.int32), r.view(torch.int32)):
                raise SystemExit(f"bokeh_bound: {label} differs from plain")
        us[label] = device_us(fn)
        print(f"{label}: {us[label]:.2f} us", flush=True)

    us = {}
    blocks_smem = per_sm(1, 0, 4 * packed.numel())
    blocks_global = per_sm(0, 0, 0)
    timed("sample", lambda: launch(packed, shared, grid))
    for k in range(1, blocks_smem + 1):
        timed(f"grid_{k}_per_sm", lambda k=k: launch(packed, True, sms * k))
    timed("grid_one_step",
          lambda: launch(packed, True, -(-b // (
              bokeh_kernel.DRAWS_PER_THREAD * bokeh_kernel.BLOCK))))
    timed("global", lambda: launch(guided, False, sms * blocks_global))
    # the benchmark's dgauss_bokeh.frame: an HD frame at AA 3 of draws on
    # the 512 x 512 disk, whose tables only the global instance takes
    big = zt.bokeh.build(zt.data.bokeh_disk(512)).to(dev)
    n_big = 1920 * 1080 * 9
    io = (torch.rand(n_big, generator=g, device=dev),
          torch.rand(n_big, generator=g, device=dev),
          torch.empty(n_big, device=dev), torch.empty(n_big, device=dev))
    ref_big = bokeh_kernel.sample_plain(big, io[0], io[1])
    t_big, shared_big, grid_big = bokeh_kernel._plan(big, n_big, False, dev)
    timed("global_512x512",
          lambda: launch(t_big, shared_big, grid_big, big, io), io[2:],
          ref_big)
    for k in range(1, blocks_global + 1):
        timed(f"global_512x512_grid_{k}_per_sm",
              lambda k=k: launch(t_big, False, sms * k, big, io), io[2:],
              ref_big)
    global_512 = {"shared": shared_big, "steps": [t_big.steps_r,
                                                  t_big.steps_c],
                  "grid": grid_big, "blocks_per_sm": blocks_global}
    del ref_big
    n_planes, bp = rt_model.plane_shape(25, b)
    cells = n_planes * bp
    pdx, pdy = (t[:cells] for t in (dx, dy))
    salts = (rt_model.SALT_P1, rt_model.SALT_P2)

    def same_planes(label, img, got):
        want_p = bokeh_kernel.planes_plain(img, cells, args.seed, *salts)
        for a, ref in zip(got, want_p):
            if not torch.equal(a.view(torch.int32), ref.view(torch.int32)):
                raise SystemExit(f"bokeh_bound: {label} differs from plain")

    rnd = np.random.default_rng(args.seed).random((300, 200, 3),
                                                  dtype=np.float32)
    rnd[::7] = 0.0
    planes = {}
    for label, img in (("planes", image), ("planes_128x128", zt.bokeh.build(
            zt.data.bokeh_disk(128)).to(dev)),
            ("planes_300x200", zt.bokeh.build(rnd).to(dev))):
        same_planes(label, img, bokeh_kernel.planes_fused(
            img, cells, args.seed, *salts))
        us[label] = device_us(lambda img=img: bokeh_kernel.planes_fused(
            img, cells, args.seed, *salts))
        t, shared_p, grid_p = bokeh_kernel._plan(img, cells, True, dev)
        planes[label] = {
            "shared": shared_p, "steps": [t.steps_r, t.steps_c],
            "grid": grid_p, "blocks_per_sm": per_sm(
                int(shared_p), 1, 4 * t.words.numel() * shared_p)}
    t = bokeh_kernel._plan(image, cells, True, dev)[0]
    plane_launch = _launch.bind("bokeh", "zoic_bokeh_planes_launch",
                                bokeh_kernel._PLANES_ARGTYPES)
    m = 0xFFFFFFFF
    for k in range(1, planes["planes"]["blocks_per_sm"] + 1):
        def fn(k=k):
            _launch.launch(
                plane_launch, "bokeh planes", dev, t.words.data_ptr(),
                pdx.data_ptr(), pdy.data_ptr(), cells, args.seed & m,
                salts[0] & m, salts[1] & m, h, w, t.words.numel(),
                t.log2_kr, t.log2_kc, t.steps_r, t.steps_c, 1, sms * k)

        fn()
        same_planes(f"planes_grid_{k}_per_sm", image, (pdx, pdy))
        us[f"planes_grid_{k}_per_sm"] = device_us(fn)
    us["copy"] = device_us(lambda: (dx.copy_(u1), dy.copy_(u2)))
    us["copy_512x512"] = device_us(lambda: (io[2].copy_(io[0]),
                                            io[3].copy_(io[1])))
    us["fill"] = device_us(lambda: (pdx.fill_(0.5), pdy.fill_(0.25)))
    for k in [k for k in us if k.startswith("planes")] + [
            "copy", "copy_512x512", "fill"]:
        print(f"{k}: {us[k]:.2f} us", flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(dev), "smi": smi,
                      "batch": b, "cells": cells, "blocks_per_sm": blocks_smem,
                      "global_512x512": global_512, "planes": planes,
                      "us": us}))


if __name__ == "__main__":
    sys.exit(main())
