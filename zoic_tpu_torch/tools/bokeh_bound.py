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
* ``global``: the global-memory instance on the same tables;
* ``planes``: the retry-plane entry over the bench's 4 x 524,288 cells;
* ``copy``: the sampler's bytes as two device copies; ``fill``: the
  planes' bytes as two fills.

    python -m zoic_tpu_torch.tools.bokeh_bound [--batch 4194304]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

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
    sample = _launch.bind("bokeh", "zoic_bokeh_launch",
                          bokeh_kernel._SAMPLE_ARGTYPES)
    per_sm = _launch.bind("bokeh", "zoic_bokeh_blocks_per_sm",
                          [ctypes.c_int] * 3)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def launch(smem: bool, blocks: int):
        _launch.launch(sample, "bokeh", dev, u1.data_ptr(), u2.data_ptr(),
                       packed.data_ptr(), dx.data_ptr(), dy.data_ptr(), b, h,
                       w, packed.numel(), int(smem), blocks)

    def timed(label, fn):
        fn()
        torch.cuda.synchronize()
        for got, ref in zip((dx, dy), want):
            if not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
                raise SystemExit(f"bokeh_bound: {label} differs from plain")
        us[label] = device_us(fn)
        print(f"{label}: {us[label]:.2f} us", flush=True)

    us = {}
    blocks_smem = per_sm(1, 0, 4 * packed.numel())
    timed("sample", lambda: launch(shared, grid))
    for k in range(1, blocks_smem + 1):
        timed(f"grid_{k}_per_sm", lambda k=k: launch(True, sms * k))
    timed("grid_one_step",
          lambda: launch(True, -(-b // (bokeh_kernel.DRAWS_PER_THREAD
                                        * bokeh_kernel.BLOCK))))
    timed("global", lambda: launch(False, sms * per_sm(0, 0, 0)))
    n_planes, bp = rt_model.plane_shape(25, b)
    cells = n_planes * bp
    pdx, pdy = (t[:cells] for t in (dx, dy))
    us["planes"] = device_us(lambda: bokeh_kernel.planes_fused(
        image, cells, args.seed, rt_model.SALT_P1, rt_model.SALT_P2))
    us["copy"] = device_us(lambda: (dx.copy_(u1), dy.copy_(u2)))
    us["fill"] = device_us(lambda: (pdx.fill_(0.5), pdy.fill_(0.25)))
    for k in ("planes", "copy", "fill"):
        print(f"{k}: {us[k]:.2f} us", flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(dev), "smi": smi,
                      "batch": b, "cells": cells, "blocks_per_sm": blocks_smem,
                      "us": us}))


if __name__ == "__main__":
    sys.exit(main())
