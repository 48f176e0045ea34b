"""The comparison that decides ``correct``: the calls the window kept,
against the plain reference (:mod:`benchmark.reference`) worked out again
from the same lens file, compile draws, bokeh image, samples and retry
seeds.

Two numbers are compared, each with the limit the configuration file
states (``limits``):

* ``ray_gap``: the largest gap, over every output of every ray of the
  kept calls (origin and ``dOdy`` in cm, direction and ``dDdy``, weight),
  between the program and the reference, leaving out the rays whose walk
  the reference decided by a comparison closer than ``BORDER`` (relative)
  to its other branch: under another rounding of the same arithmetic such
  a ray may take the other branch and then other draws.
* ``counter_gap``: the largest gap of the call's four counters
  (successes, vignetted rays, TIR cases, retry draws), over its rays.

The control (``--control bf16``) puts the reference computed in bfloat16
in the program's place; it has to come out as not correct.
"""

from __future__ import annotations

import math
import sys
import time
from typing import Dict, List, Optional

import torch

from ..reference import camera as ref_camera
from ..reference import rays as ref_rays

BORDER = 1e-4
NUMBERS = ("ray_gap", "counter_gap")
CONTROLS = {"bf16": torch.bfloat16}


def _outputs(rays) -> torch.Tensor:
    """``[B, 13]``: origin, dir, dOdy, dDdy and weight of each ray."""
    return torch.cat([rays.origin, rays.dir, rays.d_ody, rays.d_ddy,
                      rays.weight[:, None]], dim=1).float()


def gaps(prog, ref, margin: torch.Tensor) -> Dict[str, float]:
    """``ray_gap`` and diagnostics for one call; ``prog`` and ``ref`` hold
    ``origin, dir, d_ody, d_ddy, weight``."""
    d = (_outputs(prog) - _outputs(ref)).abs()
    d = torch.where(torch.isnan(d), float("inf"), d)
    per_ray = d.amax(dim=1)
    clear = margin >= BORDER
    n = per_ray.shape[0]
    ray_gap = float(per_ray[clear].max()) if bool(clear.any()) else 0.0
    return {"ray_gap": ray_gap,
            "border_share": float((~clear).sum()) / n,
            "mismatch_share": float((per_ray > 1e-4).sum()) / n,
            "gap_all": float(per_ray.max())}


def judge(kept: List, frames: list, cam, lens_path: Optional[str],
          uniforms: Optional[dict], bokeh_pixels, device, limits: dict,
          control: Optional[str] = None, log=sys.stderr) -> dict:
    """Compare every kept call; returns ``correct``, the compared numbers
    with their limits, the failed calls and the reference's states."""
    t0 = time.perf_counter()
    states = {}
    worst = {k: 0.0 for k in NUMBERS}
    failed = 0
    for c in kept:
        focus = c.focus if c.focus is not None else cam.focal_distance
        if focus not in states:
            fields = ref_camera.camera_fields(
                {**vars(cam), "focal_distance": focus})
            states[focus] = (fields, ref_camera.compile_camera(
                fields, device, lens_path=lens_path, uniforms=uniforms,
                bokeh_pixels=bokeh_pixels))
        fields, state = states[focus]
        sx, sy, lx, ly = (t[c.offset:c.offset + c.n] for t in frames[c.frame])
        ref = ref_rays.create_rays(state, fields, sx, sy, lx, ly, c.seed)
        if control is None:
            prog = c.rays
            counters = [int(v) for v in (c.stats.success, c.stats.vignetted,
                                         c.stats.tir, c.stats.tries_total)]
        else:
            prog = ref_rays.create_rays(state, fields, sx, sy, lx, ly, c.seed,
                                        dtype=CONTROLS[control])
            counters = list(prog.counters)
        g = gaps(prog, ref, ref.margin)
        cg = max(abs(a - b) for a, b in zip(counters, ref.counters)) / c.n
        one = {"ray_gap": g["ray_gap"], "counter_gap": cg}
        if not all(one[k] <= limits[k] for k in NUMBERS):
            failed += 1
        for k in NUMBERS:
            worst[k] = max(worst[k], one[k])
        print(f"check call {c.k}: {c.n} rays, focus {focus:.4f}, "
              f"counters {counters} vs reference {list(ref.counters)}, "
              f"ray_gap {g['ray_gap']:.6g}, all rays {g['gap_all']:.6g}, "
              f"borderline {g['border_share']:.6g}, mismatched "
              f"{g['mismatch_share']:.6g}", file=log)
        del ref, prog
    ok = bool(kept) and all(math.isfinite(worst[k]) and worst[k] <= limits[k]
                            for k in NUMBERS)
    return {"correct": ok, "failed": failed,
            "compared": {k: {"value": worst[k], "limit": limits[k]}
                         for k in NUMBERS},
            "states": {f: st for f, (_, st) in states.items()},
            "reference_s": time.perf_counter() - t0}
