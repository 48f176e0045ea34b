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
  (presampled offsets and retry planes, square-domain pre-check: one
  launch of the bokeh sampler, one of its retry-plane entry, no eager
  hash); then the headline lens with naive first-element shaping, and the
  headline without the pre-check;
* the lens compile: every camera of ``zoic_tpu_torch.data.CAMERAS``
  compiled on the card from the port's lens files by ``compile_camera``
  and held against its shipped state (the lens-decided static fields
  exactly, the solve's scalars to 1e-5, the LUT and bound by what they
  do: attempts/ray and the vignetted fraction of ``create_rays`` on both;
  three launches of the circle fit kernel a compile with the LUT, two
  without), then the pre-check's circle fit kernel on the headline's fit
  cover at the compile's shapes, bit-equal to the numpy fit and timed
  beside it (phase 24b);
* the op-rate microbenchmark kernel, its 13 cases against their plain
  versions (bit-equal) and beside their bounds, its hand-written square
  root, division and reciprocal against PyTorch's over every exponent and
  the specials (bit-equal), and the SM clock the card holds under load;
* the bench, ``python -m zoic_tpu_torch.bench``'s headline, which
  measures its peak op rate with the microbenchmark kernel;
* the library surface, as the README's quick start uses it (phases
  27-31): ``Camera`` and ``render`` on the headline at a 2048 x 1024 frame
  at 2 spp (the bench's batch), ``render_rays`` held to ``create_rays`` on
  the same samples and seed bit for bit, and the thin-lens camera with
  bokeh and vignetting and the raytraced camera with bokeh through the
  same calls; ``Camera.update`` (a bokeh-only change, the exposure, a
  recompile that reproduces the first compile's draws); state files and
  ``cached_compile``; the exact eager path (``impl="jnp"``) against the
  kernel and autograd on the card; data parallelism over a mesh of the one
  card and of two shards on it, and the bench with ``--mesh``;
* the diagnostics (phase 33): ``Camera`` in draw mode (``debug.draw`` at
  the reference's stride of 100,000) on the headline and on the thin lens
  with bokeh and vignetting at the same frame, its rays held to the
  draw-off call's bits and its ray tape to the same tape on the CPU, the
  ``draw.zoic`` dumps, the exit-pupil coverage against the CPU and the
  aperture self-test dump at the reference's sizes; the PNGs only where
  matplotlib is installed;
* the examples (phase 34): ``python -m zoic_tpu_torch.examples.render_demo``
  on each of the eight lenses of ``zoic_tpu_torch.data.LENSES`` at its
  defaults (a 20,000-sample LUT and the pre-check, a 192 x 128 x 4 frame,
  the ray tape, the dump, the exit-pupil coverage at 25 film points), the
  four lenses no shipped camera uses also with the kernel held to its
  plain version on the frame's samples and timed at the full batch; and
  ``python -m zoic_tpu_torch.examples.lens_optimization``, 60 Adam steps on
  the card, its first losses against the CPU's;
* the entry points (phase 35): ``zoic_tpu_torch.entry.entry()``'s
  forward step on its 65,536 example samples, twice, bit-equal between the
  calls and to ``create_rays``, and ``dryrun_multichip`` over every
  visible card, its eager pass and its kernel pass.

The raytraced kernel schedules its rays dynamically (warps take whichever
rays are ready), so it is also held to what must not depend on the
schedule: two launches on the same inputs give the same bits, batches
that do not fill a warp, a block or the persistent grid equal the plain
version, and the kernel's lane-counting build (how full the warps are when
they draw and trace, on five cameras) gives the main build's tries.

    python3 chip_smoke.py [--primer-cycles N]

Phases, one line each: the device; the kernel builds (eight ``nvcc``
runs in parallel: six sources, the two camera kernels' counting builds);
then per camera the run through ``create_rays`` checked for launches (a
raytraced camera or a thin lens: one launch of its kernel, which writes
finished rays, and no epilogue), finite outputs and its run counters, the
kernel against its plain PyTorch version on the same inputs (the
raytraced kernel's finished rays, weight, exposure, fake derivatives and
the four counters, bit for bit against the plain epilogue on the same
kernel's tries and tir, at its exposure and at +-0.5, and on the ragged
batches; the epilogue kernel, which computes them in a pass of its own,
against its plain version on that kernel's outputs bit for bit, also at
exposure +-0.5 and with tries at ``max_tries + 1``; the thin-lens kernel
against its plain version, the camera kernel's then the epilogue's, bit
for bit at its exposure and at +-0.5), and timings with
CUDA events and, for the kernel's own time on the card, torch.profiler,
with the call's device time split per kernel (a profiler reading is used
only where its window kept one record per call and events >= card >=
bound holds; else it reads "no reading", null in the JSON); the bokeh
kernel against
its plain version on 4,194,304 draws (bit-equal) on both of its paths
(tables in shared memory: the 64x64 disk and a 128x128 disk; in global
memory: a 300x200 image), and its retry-plane entry against the eager
hash and sampler at the bench's 4 x 524,288 cells and at the ragged
batches' cell counts (bit-equal); ragged batches; lane use; the compiles;
the microbenchmark (rates, the IEEE sweep, the clock held); the bench's
JSON line and its bursts' spread; the library surface (render and
compile times by CUDA events and the host clock, the eager path beside
the kernel, the bench's ``--mesh`` JSON line); the diagnostics (the
tape's time beside ``create_rays``' with and without draw mode); the
examples (per lens the compile's seconds, the render's time, vignetting,
the tape's segments and the coverage; the optimisation's losses); the
entry points (shapes, launches, the dry run's counters).  Then the
summary line (with the profiler readings taken and rejected), one JSON
line of the kernel table (seven entries: the six sources and the bokeh
source's plane entry apart), the card's name and power limit from
nvidia-smi, and last ``{"ok": true, "device": ...}``.  Any failed check exits non-zero before the last line.
It needs a CUDA card and ``nvcc``, and imports nothing of jax.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
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
# the library phases' frame: width, height, samples per pixel (BATCH rays)
FRAME = (2048, 1024, 2)
MAX_TRIES = 25
SEED = 20261016
# kernel vs plain: tries/tir may differ on at most 0.01% of rays (borderline
# compares under a different atan2f build); payloads of rays whose tries
# agree and are live must agree to 1e-5 absolute
MAX_TRIES_MISMATCH = 419
PAYLOAD_ATOL = 1e-5
KERNELS = ("raytraced", "thinlens", "bokeh", "roofline", "epilogue",
           "circles")
# the builds: every source with --fmad=false, the camera kernels also
# counting lanes
COUNT_LANES = ("ZOIC_COUNT_LANES",)
BUILDS = (*KERNELS, ("raytraced", False, COUNT_LANES),
          ("thinlens", False, COUNT_LANES))
# batches that do not fill a warp, a tile row or (the last, plus what
# main() adds: just under one block per SM) the persistent grid
RAGGED_SIZES = (1, 31, 33, 2_125)
# the diagnostics phase: the reference's draw stride (zoic.cpp:1760), so
# ceil(BATCH / DRAW_STRIDE) taped rays a call; the tape on the card against
# the CPU's: hit points absolutely, exit endpoints (x 10,000) relatively;
# the exit-pupil coverage's draws and the self-test at the reference's
# sizes (zoic.cpp:1354-1388, 1458-1537)
DRAW_STRIDE = 100_000
TAPED_RAYS = 42
TAPE_ATOL = 1e-5
TAPE_EXIT_RTOL = 1e-5
COVERAGE_N = 10_000
SELFTEST = dict(film_grid=3, n_gt=10_000, n_ss=5_000)
RAY_FIELDS = ("origin", "dir", "weight", "d_ody", "d_ddy")
# the examples phase: the render demo's frame holds the kernel to the plain
# version at the gate's share (0.01% of its rays); the lens optimisation's
# first losses on the card against the CPU's, relative, and the share of
# the perturbation it must take back (the JAX example's run takes 101%)
EXAMPLE_LOSSES = 10
EXAMPLE_LOSSES_RTOL = 1e-4
EXAMPLE_MIN_RECOVERED = 0.9
# the raytraced kernel's least work on a lens, from bench.py's counts:
# element-ops per aperture draw (hash, shaping, pre-check) for every
# attempt, and per trace for every ray that succeeds (it was traced once
# at least); rejected traces are not counted
DRAW_OPS = 72
TRACE_OPS = 560
PROFILED_CALLS = 5
PROFILE_WINDOWS = 3
# the kernel that opens each profiler window, torch.cuda._sleep's, spinning
# PRIMER_CYCLES clocks (PERF.md section 7); --primer-cycles 0 opens the
# windows without it
PRIMER = "spin_kernel"
PRIMER_CYCLES = 1000
# the profiler's readings: taken (a window passed its checks), and rejected
# (no window did: "no reading"); taken + rejected are the readings tried
READINGS = {"taken": 0, "rejected": 0}
# the card's published peaks (H100 SXM datasheet): HBM
# bytes/s, and float32 outside the tensor cores, 67 TFLOP/s counting an FMA
# as two; one element-op per lane per clock is half of it
HBM_BYTES_PER_S = 3.35e12
# an FP64 add or multiply a slot of the FP64 pipes: the H100 SXM's 33.5e12
# FP64 FLOP/s count an fma as two
FP64_OPS_PER_S = 16.75e12
# the circle fit phase: the compile's samples a key, timed calls an entry
CIRCLES_N = 50_000
CIRCLES_ITERS = 10
F32_ELEMENT_OPS_PER_S = 67e12 / 2
# element-ops per ray: the raytraced kernel's is the bench's work count
# (zoic_tpu_torch.bench.USEFUL_OPS_PER_RAY); the thin-lens kernel's and the
# bokeh kernel's are upper estimates from their sources, far below their
# byte bounds either way; a plane cell adds two counter hashes of 15
# integer ops each (common.cuh:hash_uniform), counted at the f32 rate
THINLENS_OPS_PER_RAY = 60
BOKEH_OPS_PER_DRAW = 30
PLANE_OPS_PER_CELL = BOKEH_OPS_PER_DRAW + 2 * 15
# the epilogue kernel's element-ops a ray, an upper estimate from its
# source (compares and selects for the weight, the exposure and six
# derivative components, four counter adds), far below its byte bound
EPILOGUE_OPS_PER_RAY = 16
# the bokeh kernel's images: (label, shape or None for the benchmark's disk
# file, path expected: tables in shared memory)
BOKEH_IMAGES = (("64x64 disk", None, True), ("128x128 disk", (128, 128), True),
                ("300x200 random", (300, 200), False))
# the plane entry's time before its guide tables (PERF.md section 6, the
# earlier ms of row 3b), quoted beside the time this run measures
PLANES_EARLIER = ("0.0157 ms on the card, 0.0402 ms by events (PERF.md "
                  "row 3b; NVIDIA H100 80GB HBM3, 700.00 W)")
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


def profile_window(fn, host: bool):
    """One torch.profiler window of ``PROFILED_CALLS`` calls of ``fn()``,
    with host and device activity (a trace written under
    ``build/chip_smoke/trace``) or the device's alone: ``(records,
    calls)``, each record on the card ``(name, us, start ms, end ms)`` and
    ``calls`` the host's ms of the first call and of the synchronise's
    return, all from the window's start.  The window opens with a short
    ``PRIMER`` kernel and a synchronise, and its record is dropped: late in
    a long process the profiler lost the first launches of a window
    (PERF.md section 7)."""
    from zoic_tpu_torch.utils import profiling

    log_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "chip_smoke", "trace")
    with (profiling.trace(log_dir) if host else torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])) as prof:
        t_in = time.perf_counter()
        if PRIMER_CYCLES:
            torch.cuda._sleep(PRIMER_CYCLES)
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PROFILED_CALLS):
            fn()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    records = [(e.name, e.device_time_total, e.time_range.start / 1e3,
                e.time_range.end / 1e3) for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.device_time_total > 0 and PRIMER not in e.name]
    return records, ((t0 - t_in) * 1e3, (t1 - t_in) * 1e3)


def card_reading(fn, match: str, events_ms: float, bound_ms: float,
                 tag: str, whole_call: bool = False):
    """The time on the card of the kernel whose name holds ``match``, per
    call of ``fn()`` (each call launches it once), by torch.profiler.

    After one warm-up call, a window (host and device activity) must keep
    exactly ``PROFILED_CALLS`` records of the kernel (fewer are records
    lost, more are foreign ones) and their mean must satisfy ``events_ms
    >= card >= bound_ms``: ``events_ms`` the median of the same calls by
    CUDA events, ``bound_ms`` the least time the card could take.  A window
    that fails is not used and the device alone is profiled again, up to
    ``PROFILE_WINDOWS`` windows in all; where none passes the reading is
    None ("no reading").  With ``whole_call`` (``fn`` a ``create_rays``)
    the reading also splits the call's device time: every other kernel's
    mean times its launches a call, the sum held under ``events_ms``.
    Prints each window's record count on one line under ``tag``; counts
    the reading in ``READINGS``."""
    fn()
    torch.cuda.synchronize()
    want, notes = PROFILED_CALLS, []
    for window in range(PROFILE_WINDOWS):
        records, (first_call, synced) = profile_window(fn, host=window == 0)
        mine = [r for r in records if match in r[0]]
        own = [r[1] / 1e3 for r in mine]
        card = sum(own) / len(own) if own else None
        ok = len(own) == want and events_ms >= card >= bound_ms
        if whole_call:
            split = {"own_us": 0.0, "other_us": 0.0, "kernels": 0,
                     "other_ops": 0}
            for name in {r[0] for r in records}:
                us = [r[1] for r in records if r[0] == name]
                per_call = max(1, round(len(us) / PROFILED_CALLS))
                mean_us = sum(us) / len(us) * per_call
                is_own = match in name
                split["own_us" if is_own else "other_us"] += mean_us
                split["kernels"] += per_call
                split["other_ops"] += 0 if is_own else per_call
            total = (split["own_us"] + split["other_us"]) / 1e3
            ok = ok and events_ms >= total
        kind = "host + device" if window == 0 else "device"
        notes.append(
            f"window {window + 1} ({kind}): {len(own)} records of {want}"
            + (f", {min(own):.4f}-{max(own):.4f} ms each, mean {card:.4f}, "
               f"the first {min(r[2] for r in mine) - first_call:+.3f} ms "
               f"from the first call, the last ending "
               f"{synced - max(r[3] for r in mine):+.3f} ms before the "
               f"synchronise returned" if own else "")
            + (f", the call {total:.4f}" if whole_call else "")
            + f": {'taken' if ok else 'rejected'}")
        if ok:
            break
    READINGS["taken" if ok else "rejected"] += 1
    if not ok:
        notes.append(
            f"no reading (events {events_ms:.4f} ms, card "
            + (f"{card:.4f} ms" if own else "none")
            + f", bound {bound_ms:.4f} ms, {len(own)} records of {want})")
    print(f"[{tag} card {match}] events {events_ms:.4f} ms >= card >= bound "
          f"{bound_ms:.4f} ms, {want} records: " + "; ".join(notes),
          flush=True)
    if not ok:
        return None
    return split if whole_call else card


def kernel_count(fn, tag: str):
    """Kernels on the card per call of ``fn()``, by torch.profiler: a
    window's records over ``PROFILED_CALLS``.  The count is used only where
    it is a whole non-zero multiple of ``PROFILED_CALLS`` and two windows
    in a row agree on it (the first records host and device activity, the
    repeats the device's alone, up to ``PROFILE_WINDOWS`` windows); else
    None ("no reading").  Prints each window's count on one line under
    ``tag``; counts the reading in ``READINGS``."""
    fn()
    torch.cuda.synchronize()
    seen, per_call = [], None
    for window in range(PROFILE_WINDOWS):
        n = len(profile_window(fn, host=window == 0)[0])
        if n > 0 and n % PROFILED_CALLS == 0 and seen and seen[-1] == n:
            per_call = n // PROFILED_CALLS
        seen.append(n)
        if per_call is not None:
            break
    READINGS["taken" if per_call is not None else "rejected"] += 1
    print(f"[{tag} kernels a call] records of {PROFILED_CALLS} calls by "
          f"window (the first host + device, then device): "
          f"{', '.join(map(str, seen))}: "
          + (f"{per_call} a call" if per_call is not None else
             "no reading (no two windows in a row agree on a whole multiple)"),
          flush=True)
    return per_call


def card_text(ms) -> str:
    return "no reading" if ms is None else f"{ms:.4f} ms"


def split_text(split, match: str) -> str:
    if split is None:
        return "create_rays on the card: no reading"
    return (f"create_rays on the card: {match} {split['own_us']:.1f} us, "
            f"other operations {split['other_ops']} a call, "
            f"{split['other_us']:.1f} us, {split['kernels']} "
            f"kernels per call (profiler, {PROFILED_CALLS} calls)")


def bits_equal(a, b) -> bool:
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(a, b))


def reset_counts(trace_kernel, bokeh_kernel, roofline_kernel=None) -> None:
    from zoic_tpu_torch.ops import epilogue_kernel

    epilogue_kernel.launches = 0
    trace_kernel.launches = 0
    trace_kernel.raytraced_rays_launches = 0
    trace_kernel.thinlens_rays_launches = 0
    bokeh_kernel.launches = 0
    bokeh_kernel.plane_launches = 0
    if roofline_kernel is not None:
        roofline_kernel.launches = 0


def bound(bytes_moved: float, ops: float):
    """``(bound_ms, bound_by)``: the larger of the bytes over the card's
    memory rate and the element-ops over its f32 rate."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / F32_ELEMENT_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def raytraced_ops(tries, max_tries: int) -> float:
    """The raytraced kernel's least element-ops on a batch from its tries:
    ``DRAW_OPS`` per attempt, ``TRACE_OPS`` per ray that succeeds."""
    return (DRAW_OPS * (tries.numel() + int(tries.sum()))
            + TRACE_OPS * int((tries <= max_tries).sum()))


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def median_line(timed) -> str:
    parts = []
    for name, ts in timed.items():
        med = statistics.median(ts)
        parts.append(f"{name} {med:.4f} ms = {BATCH / med / 1e3:.1f} M "
                     f"rays/s (min {min(ts):.4f}, max {max(ts):.4f})")
    return "; ".join(parts)


def kernel_vs_plain(trace_kernel, name, args, kw, max_tries, tag, limit):
    """The raytraced kernel against its plain version on ``args``/``kw``:
    ``tries``/``tir`` may differ on at most ``limit`` rays, the payloads of
    rays whose tries agree and are live within ``PAYLOAD_ATOL``, and two
    launches must give the same bits (the schedule is dynamic, the result
    must not be).  Prints one line under ``tag``."""
    ko, kd, kt, ktir = trace_kernel.raytraced_fused(*args, **kw)
    po, pd, pt, ptir = trace_kernel.raytraced_plain(*args, **kw)
    torch.cuda.synchronize()
    n = kt.numel()
    mismatch = int(((kt != pt) | (ktir != ptir)).sum())
    same = (kt == pt) & (ktir == ptir) & (kt <= max_tries)
    check(bool(same.any()), f"{name}: no live ray to compare")
    err_o = float((ko - po)[same].abs().max())
    err_d = float((kd - pd)[same].abs().max())
    err_all = max(float((ko - po).abs().max()), float((kd - pd).abs().max()))
    print(f"[{tag}] tries/tir mismatches {mismatch} of {n} (limit {limit}); "
          f"live max |d origin| {err_o:.3e} |d dir| {err_d:.3e} (limit "
          f"{PAYLOAD_ATOL}); all rays {err_all:.3e}", flush=True)
    check(mismatch <= limit, f"{name}: kernel and plain disagree on tries")
    check(max(err_o, err_d) <= PAYLOAD_ATOL,
          f"{name}: kernel and plain payloads disagree")
    again = trace_kernel.raytraced_fused(*args, **kw)
    check(bits_equal(again, (ko, kd, kt, ktir)),
          f"{name}: two launches on the same inputs differ")
    return {"out": (ko, kd, kt, ktir), "mismatches": mismatch,
            "max_abs_err": max(err_o, err_d)}


def epilogue_vs_plain(name, tries, tir, origin, direction, exposure,
                      max_tries, tag, smi=None):
    """The epilogue kernel against its plain version on one phase's camera
    kernel outputs, bit for bit (the weight, both derivatives, the four
    counters): at the state's exposure, at +0.5 and -0.5, and with every
    7th ray's tries at ``max_tries + 1``; two launches must give the same
    bits.  With ``smi`` also its time by CUDA events and on the card
    (profiler) beside the plain version's and its byte bound.  Prints one
    line under ``tag``; returns the largest difference (0 when bit-equal)
    and, with ``smi``, the times."""
    from zoic_tpu_torch.ops import epilogue_kernel as ek

    dev = tries.device
    over = tries.clone()
    over[::7] = max_tries + 1
    cases = [("the state's exposure", tries, exposure)]
    cases += [(f"exposure {e:+}", tries,
               torch.tensor(e, dtype=torch.float32, device=dev))
              for e in (0.5, -0.5)]
    cases.append(("tries max_tries + 1 on every 7th ray", over, exposure))
    worst, stats, outs = 0.0, {}, []
    for label, t, ex in cases:
        args = (t, tir, origin, direction, ex, max_tries)
        k = ek.epilogue_fused(*args)
        p = ek.epilogue_plain(*args)
        torch.cuda.synchronize()
        if t.numel():
            worst = max([worst] + [float((a - b).abs().max())
                                   for a, b in zip(k[:3], p[:3])])
        stats[label] = k[3].tolist()
        check(bits_equal(k, p), f"{name}: the epilogue kernel and its plain "
              f"version differ ({label}): stats {k[3].tolist()} vs "
              f"{p[3].tolist()}")
        outs.append(k)
    first = outs[0]
    again = ek.epilogue_fused(tries, tir, origin, direction, exposure,
                              max_tries)
    check(bits_equal(again, first),
          f"{name}: two epilogue launches on the same inputs differ")
    out = {"max_abs_err": worst}
    line = (f"[{tag}] B = {tries.numel()}: weight, dOdy, dDdy and the "
            f"counters bit-equal to the plain version in {len(cases)} cases "
            f"(stats {stats}); two launches bit-equal")
    if smi is not None:
        args = (tries, tir, origin, direction, exposure, max_tries)

        def fused():
            return ek.epilogue_fused(*args)

        timed = {"kernel": time_ms(fused, lambda: ()),
                 "plain": time_ms(lambda: ek.epilogue_plain(*args),
                                  lambda: ())}
        n_bytes = nbytes(tries, tir, origin, direction, exposure, *first)
        ep_bound = bound(n_bytes, EPILOGUE_OPS_PER_RAY * tries.numel())
        kernel_ms = statistics.median(timed["kernel"])
        dev_ms = card_reading(fused, "epilogue_kernel", kernel_ms,
                              ep_bound[0], tag)
        out.update(kernel_ms=kernel_ms, device_ms=dev_ms,
                   plain_ms=statistics.median(timed["plain"]),
                   bytes=n_bytes, bound=ep_bound)
        line += (f"; median of 10 (3 warm-up), on {smi}: "
                 + median_line(timed) + f"; kernel on the card "
                 f"{card_text(dev_ms)} (profiler, {PROFILED_CALLS} launches; "
                 f"bound {ep_bound[0]:.4f} ms, {ep_bound[1]}, "
                 f"{n_bytes / tries.numel():.0f} B/ray)")
    print(line, flush=True)
    return out


def finished_vs_plain(trace_kernel, name, args, kw, fused, exposure,
                      max_tries, tag):
    """The raytraced kernel's finished rays (``raytraced_rays``) against
    the plain epilogue on the same kernel's rays (``fused``, from
    ``raytraced_fused``) bit for bit, every output and the four counters:
    at the state's exposure and at +0.5 and -0.5; two launches must give
    the same bits.  Prints one line under ``tag``."""
    from zoic_tpu_torch.ops import epilogue_kernel as ek

    dev = args[1].device
    cases = [("the state's exposure", exposure)] + [
        (f"exposure {e:+}", torch.tensor(e, dtype=torch.float32, device=dev))
        for e in (0.5, -0.5)]
    origin, direction, tries, tir = fused
    stats, first = {}, None
    for label, ex in cases:
        k = trace_kernel.raytraced_rays(*args, ex, **kw)
        p = (origin, direction) + ek.epilogue_plain(
            tries, tir, origin, direction, ex, max_tries)
        torch.cuda.synchronize()
        stats[label] = k[5].tolist()
        check(bits_equal(k, p), f"{name}: the finished rays and the plain "
              f"epilogue on the kernel's rays differ ({label}): stats "
              f"{k[5].tolist()} vs {p[5].tolist()}")
        first = first or k
    again = trace_kernel.raytraced_rays(*args, exposure, **kw)
    check(bits_equal(again, first),
          f"{name}: two launches of the finished rays differ")
    print(f"[{tag}] B = {tries.numel()}: origin, dir, weight, dOdy, dDdy "
          f"and the counters bit-equal to the plain epilogue on the "
          f"kernel's rays in {len(cases)} cases (stats {stats}); two "
          f"launches bit-equal", flush=True)
    return first


def rays_vs_plain(trace_kernel, name, args, kw, exposure, tag):
    """The thin lens's whole kernel path (``thinlens_rays``) against its
    plain version (``thinlens_rays_plain``: the camera kernel's plain
    version, then the epilogue's) bit for bit, every output and the four
    counters: at the state's exposure and at +0.5 and -0.5; two launches
    must give the same bits.  Prints one line under ``tag``; returns the
    first case's outputs."""
    dev = args[0].device
    cases = [("the state's exposure", exposure)] + [
        (f"exposure {e:+}", torch.tensor(e, dtype=torch.float32, device=dev))
        for e in (0.5, -0.5)]
    stats, first = {}, None
    for label, ex in cases:
        k = trace_kernel.thinlens_rays(*args, ex, **kw)
        p = trace_kernel.thinlens_rays_plain(*args, ex, **kw)
        torch.cuda.synchronize()
        stats[label] = k[5].tolist()
        check(bits_equal(k, p), f"{name}: the thin-lens kernel and its "
              f"plain version differ ({label}): stats {k[5].tolist()} vs "
              f"{p[5].tolist()}")
        first = first or k
    again = trace_kernel.thinlens_rays(*args, exposure, **kw)
    check(bits_equal(again, first),
          f"{name}: two launches of the thin-lens kernel differ")
    print(f"[{tag}] B = {args[0].numel()}: origin, dir, weight, dOdy, "
          f"dDdy and the counters bit-equal to the plain version in "
          f"{len(cases)} cases (stats {stats}); two launches bit-equal",
          flush=True)
    return first


def fresh_inputs(state, cfg, tg: torch.Generator, dev):
    """A maker of the raytraced kernel's arguments at ``BATCH``: fresh
    draws, retry seed and planes per call, from the generator ``tg``."""
    from zoic_tpu_torch.models import raytraced as rt_model

    def fresh():
        s = int(torch.randint(0, 1 << 22, (), generator=tg, device=dev))
        a, b, c, d = draws(tg, BATCH, dev)
        c, d, fkw = rt_model.kernel_inputs(state, cfg, c, d, s)
        return (state.lens, a, b, c, d, state.sensor_width, s, fkw)

    return fresh


def raytraced_phase(zt, trace_kernel, bokeh_kernel, name, state, cfg, dev,
                    smi, tags, time_plain=True, headline=False):
    """Drive one raytraced camera through create_rays, check the run (one
    launch of the kernel writing finished rays, no epilogue), hold the
    kernel, its finished rays and the epilogue kernel against their plain
    versions on the same inputs, seed and retry planes, and time the
    kernel in both of its modes, create_rays and, with ``time_plain``, the
    plain version.  ``tags`` label the lines; the headline camera is also
    held to its attempts/ray and vignetted fraction, and its epilogue
    timed."""
    from zoic_tpu_torch.models import raytraced as rt_model
    from zoic_tpu_torch.ops import epilogue_kernel as ek

    g = torch.Generator(device=dev).manual_seed(SEED)
    sx, sy, lx, ly = draws(g, BATCH, dev)

    # the eager counter hash must not run: the plane entry hashes on the card
    eager_hash, hashes = trace_kernel.hash_uniform, []
    trace_kernel.hash_uniform = (
        lambda *a, **k: hashes.append(1) or eager_hash(*a, **k))
    try:
        reset_counts(trace_kernel, bokeh_kernel)
        rays, stats = zt.create_rays(state, cfg, sx, sy, lx, ly, generator=g)
        torch.cuda.synchronize()
    finally:
        trace_kernel.hash_uniform = eager_hash
    n_launch, n_bokeh = (trace_kernel.raytraced_rays_launches,
                         bokeh_kernel.launches)
    n_planes, n_epilogue = bokeh_kernel.plane_launches, ek.launches
    check(n_launch == 1 and trace_kernel.launches == 0,
          f"{name}: {n_launch} launches of the finished rays, "
          f"{trace_kernel.launches} of the kernel's tries")
    check(n_epilogue == 0, f"{name}: {n_epilogue} epilogue launches")
    check(trace_kernel.thinlens_rays_launches == 0,
          f"{name}: a thinlens kernel launched")
    check(n_bokeh == int(cfg.use_image),
          f"{name}: {n_bokeh} bokeh launches with use_image={cfg.use_image}")
    check(n_planes == int(cfg.use_image and cfg.max_tries > 0),
          f"{name}: {n_planes} plane launches")
    check(not hashes, f"{name}: the eager hash ran {len(hashes)} times")
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
    print(f"[{tags[0]}] launches raytraced_rays {n_launch} bokeh {n_bokeh} "
          f"planes {n_planes} epilogue {n_epilogue}, eager hashes 0; "
          f"success {success} vignetted {vig} tir {int(stats.tir)}; "
          f"attempts/ray {attempts:.6f}; vignetted frac {vig_frac:.6f}; "
          f"max ||dir|-1| {norm_err:.2e}", flush=True)

    # kernel vs plain on the same inputs, seed and retry planes
    seed = SEED % (1 << 22)
    u1, u2, kw = rt_model.kernel_inputs(state, cfg, lx, ly, seed)
    args = (state.lens, sx, sy, u1, u2, state.sensor_width, seed)
    cmp = kernel_vs_plain(trace_kernel, name, args, kw, cfg.max_tries,
                          tags[1], MAX_TRIES_MISMATCH)
    ko, kd, kt, ktir = cmp["out"]
    max_abs_err, mismatch = cmp["max_abs_err"], cmp["mismatches"]
    finished_vs_plain(trace_kernel, name, args, kw, cmp["out"],
                      state.exposure_control, cfg.max_tries,
                      tags[1].replace("kernel vs plain",
                                      "finished rays vs plain"))
    n_before = ek.launches
    epi = epilogue_vs_plain(
        name, kt, ktir, ko, kd, state.exposure_control, cfg.max_tries,
        tags[1].replace("kernel vs plain", "epilogue vs plain"),
        smi if headline else None)

    # timings (information only), fresh draws, seed and planes per call
    tg = torch.Generator(device=dev).manual_seed(SEED + 1)
    fresh = fresh_inputs(state, cfg, tg, dev)

    def e2e_args():
        return (*draws(tg, BATCH, dev),
                int(torch.randint(0, 1 << 22, (), generator=tg, device=dev)))

    exposure = state.exposure_control
    timed = {"kernel": time_ms(
        lambda *a: trace_kernel.raytraced_fused(*a[:7], **a[7]), fresh),
             "finished": time_ms(
        lambda *a: trace_kernel.raytraced_rays(*a[:7], exposure, **a[7]),
        fresh)}
    n_epilogue_tests = ek.launches - n_before
    if time_plain:
        timed["plain"] = time_ms(
            lambda *a: trace_kernel.raytraced_plain(*a[:7], **a[7]), fresh)
    timed["create_rays"] = time_ms(
        lambda *a: zt.create_rays(state, cfg, *a[:4], seed=a[4]), e2e_args)
    planes = [t for t in (kw["retry_u1"], kw["retry_u2"]) if t is not None]
    n_bytes = nbytes(sx, sy, u1, u2, ko, kd, kt, ktir, *planes)
    rt_bound = bound(n_bytes, raytraced_ops(kt, cfg.max_tries))
    dev_ms = card_reading(
        lambda: trace_kernel.raytraced_fused(*args, **kw), "raytraced_kernel",
        statistics.median(timed["kernel"]), rt_bound[0], tags[2])
    finished_ms = card_reading(
        lambda: trace_kernel.raytraced_rays(*args, exposure, **kw),
        "raytraced_kernel", statistics.median(timed["finished"]),
        rt_bound[0], tags[2])
    split = card_reading(
        lambda: zt.create_rays(state, cfg, sx, sy, lx, ly, seed=seed),
        "raytraced_kernel", statistics.median(timed["create_rays"]),
        rt_bound[0], tags[2], whole_call=True)
    print(f"[{tags[2]}] median of 10 (3 warm-up), B = {BATCH}, on {smi}: "
          + median_line(timed) + f"; kernel on the card {card_text(dev_ms)}"
          f", writing finished rays {card_text(finished_ms)} "
          f"(profiler, {PROFILED_CALLS} launches; bound {rt_bound[0]:.4f} ms,"
          f" {rt_bound[1]}); two launches bit-equal; "
          + split_text(split, "raytraced_kernel"), flush=True)
    return {"launches": n_launch, "bokeh_launches": n_bokeh,
            "plane_launches": n_planes,
            "epilogue_launches": n_epilogue_tests,
            "epilogue": epi, "split": split, "bytes": n_bytes,
            "max_abs_err": max_abs_err, "mismatches": mismatch,
            "attempts": attempts, "vignetted_frac": vig_frac,
            "kernel_ms": statistics.median(timed["kernel"]),
            "device_ms": dev_ms,
            "finished_ms": statistics.median(timed["finished"]),
            "finished_device_ms": finished_ms,
            "plain_ms": (statistics.median(timed["plain"])
                         if time_plain else None),
            "create_rays_ms": statistics.median(timed["create_rays"])}


def thinlens_phase(zt, trace_kernel, bokeh_kernel, name, cfg, dev, smi,
                   tag):
    """Drive one thin-lens config through compile_camera + create_rays
    (one launch of the thin-lens kernel, no epilogue), check the run, hold
    the kernel against its plain version on the same inputs, and time
    kernel, plain and create_rays."""
    from zoic_tpu_torch.models import thinlens as thin_model
    from zoic_tpu_torch.ops import epilogue_kernel as ek

    state = zt.compile_camera(cfg, dev)
    g = torch.Generator(device=dev).manual_seed(SEED)
    sx, sy, lx, ly = draws(g, BATCH, dev)

    reset_counts(trace_kernel, bokeh_kernel)
    rays, stats = zt.create_rays(state, cfg, sx, sy, lx, ly, generator=g)
    torch.cuda.synchronize()
    n_rays, n_bokeh = (trace_kernel.thinlens_rays_launches,
                       bokeh_kernel.launches)
    n_epilogue = ek.launches
    check(n_rays == 1, f"{name}: {n_rays} launches of the thin-lens kernel")
    check(n_epilogue == 0, f"{name}: {n_epilogue} epilogue launches")
    check(trace_kernel.launches + trace_kernel.raytraced_rays_launches == 0,
          f"{name}: a raytraced kernel launched")
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
    print(f"[{tag}a {name}] launches thinlens_rays {n_rays} bokeh {n_bokeh} "
          f"epilogue {n_epilogue}; "
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
    ex = state.exposure_control
    first = rays_vs_plain(trace_kernel, name, args, kw, ex,
                          f"{tag}b {name} kernel vs plain")

    # timings (information only), fresh draws and seed per call
    tg = torch.Generator(device=dev).manual_seed(SEED + 1)

    def fresh():
        s = int(torch.randint(0, 1 << 22, (), generator=tg, device=dev))
        a, b, c, d = draws(tg, BATCH, dev)
        if cfg.use_image:
            c, d = bokeh_kernel.sample_fused(state.bokeh, c, d)
        return (a, b, c, d, *args[4:9], s, ex)

    def e2e_args():
        return (*draws(tg, BATCH, dev),
                int(torch.randint(0, 1 << 22, (), generator=tg, device=dev)))

    timed = {
        "kernel": time_ms(lambda *a: trace_kernel.thinlens_rays(*a, **kw),
                          fresh),
        "plain": time_ms(
            lambda *a: trace_kernel.thinlens_rays_plain(*a, **kw), fresh),
        "create_rays": time_ms(
            lambda *a: zt.create_rays(state, cfg, *a[:4], seed=a[4],
                                      generator=tg), e2e_args),
    }
    # the pinhole reads no lens samples
    n_bytes = nbytes(*args[:4 if cfg.use_dof else 2], *first[:5],
                     *planes.values())
    thin_bound = bound(n_bytes,
                       (THINLENS_OPS_PER_RAY + EPILOGUE_OPS_PER_RAY) * BATCH)
    dev_ms = card_reading(
        lambda: trace_kernel.thinlens_rays(*args, ex, **kw),
        "thinlens_kernel", statistics.median(timed["kernel"]),
        thin_bound[0], f"{tag}c")
    split = card_reading(
        lambda: zt.create_rays(state, cfg, sx, sy, lx, ly, seed=seed,
                               generator=g), "thinlens_kernel",
        statistics.median(timed["create_rays"]), thin_bound[0], f"{tag}c",
        whole_call=True)
    print(f"[{tag}c {name} timing] median of 10 (3 warm-up), B = {BATCH}, "
          f"on {smi}: " + median_line(timed) + f"; kernel on the card "
          f"{card_text(dev_ms)} (profiler, {PROFILED_CALLS} launches; bound "
          f"{thin_bound[0]:.4f} ms, {thin_bound[1]}, "
          f"{n_bytes / BATCH:.0f} B/ray); "
          + split_text(split, "thinlens_kernel"), flush=True)
    return {"bokeh_launches": n_bokeh, "launches": n_rays, "split": split,
            "bytes": n_bytes, "bound": thin_bound, "max_abs_err": 0.0,
            "kernel_ms": statistics.median(timed["kernel"]),
            "device_ms": dev_ms,
            "plain_ms": statistics.median(timed["plain"]),
            "create_rays_ms": statistics.median(timed["create_rays"])}


def edge_draws(image, g, dev):
    """B uniforms on the card, led by 0.0, 1 - 2**-24 and the image's CDF
    entries (as many as fit in a tenth of the batch)."""
    u1 = torch.rand(BATCH, generator=g, device=dev)
    u2 = torch.rand(BATCH, generator=g, device=dev)
    edge = torch.tensor([0.0, 1.0 - 2.0**-24], device=dev)
    e1 = torch.cat([edge, image.cdf_row])[:BATCH // 10]
    e2 = torch.cat([edge, image.cdf_col.reshape(-1)])[:BATCH // 10]
    u1[:e1.numel()] = e1
    u2[:e2.numel()] = e2
    return u1, u2


def plane_images(zt):
    """``(label, pixels, tables in shared memory)`` of the plane entry's
    images besides the bench's: a 128x128 disk, 300x200 random pixels with
    every seventh row dark, and a 64x64 image dark but for one pixel."""
    rnd = np.random.default_rng(SEED).random((300, 200, 3), dtype=np.float32)
    rnd[::7] = 0.0
    spike = np.zeros((64, 64, 3), np.float32)
    spike[20, 30] = 1.0
    return (("128x128 disk", zt.data.bokeh_disk(128), True),
            ("300x200 random", rnd, False), ("64x64 spike", spike, True))


def bokeh_phase(zt, bokeh_kernel, bokeh_path, dev, smi, tag):
    """The bokeh kernel against its plain version on B draws, bit-equal, on
    each image of ``BOKEH_IMAGES`` (both of the kernel's paths), and its
    timings; the first image's are the kernel table's."""
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    rows = {}
    for i, (label, shape, shared) in enumerate(BOKEH_IMAGES):
        if shape is None:
            image = zt.bokeh.load(bokeh_path)
        elif shape[0] == shape[1]:
            image = zt.bokeh.build(zt.data.bokeh_disk(shape[0]))
        else:
            pixels = np.random.default_rng(SEED).random((*shape, 3),
                                                        dtype=np.float32)
            pixels[::7] = 0.0
            image = zt.bokeh.build(pixels)
        image = image.to(dev)
        check(bokeh_kernel._plan(image, BATCH, False, dev)[1] == shared,
              f"bokeh {label}: tables not in "
              f"{'shared' if shared else 'global'} memory")
        u1, u2 = edge_draws(image, g, dev)
        kdx, kdy = bokeh_kernel.sample_fused(image, u1, u2)
        pdx, pdy = bokeh_kernel.sample_plain(image, u1, u2)
        torch.cuda.synchronize()
        bits = [int((k.view(torch.int32) != p.view(torch.int32)).sum())
                for k, p in ((kdx, pdx), (kdy, pdy))]
        err = max(float((kdx - pdx).abs().max()),
                  float((kdy - pdy).abs().max()))
        print(f"[{tag}{'abc'[i]} bokeh kernel vs plain] {label} "
              f"({image.height}x{image.width}, tables in "
              f"{'shared' if shared else 'global'} memory), {BATCH} draws: "
              f"bit mismatches dx {bits[0]} dy {bits[1]} (limit 0); max |d| "
              f"{err:.3e}", flush=True)
        check(bits == [0, 0], f"bokeh {label}: kernel and plain are not "
              "bit-equal")

        def fresh(image=image):
            return (image, torch.rand(BATCH, generator=g, device=dev),
                    torch.rand(BATCH, generator=g, device=dev))

        timed = {"kernel": time_ms(bokeh_kernel.sample_fused, fresh),
                 "plain": time_ms(bokeh_kernel.sample_plain, fresh)}
        n_bytes = nbytes(u1, u2, kdx, kdy, bokeh_kernel.packed_tables(image))
        bk_bound = bound(n_bytes, BOKEH_OPS_PER_DRAW * BATCH)
        dev_ms = card_reading(
            lambda: bokeh_kernel.sample_fused(image, u1, u2), "bokeh_kernel",
            statistics.median(timed["kernel"]), bk_bound[0],
            f"{tag}{'abc'[i]}")
        rows[label] = {
            "max_abs_err": err, "bytes": n_bytes, "bound": bk_bound,
            "kernel_ms": statistics.median(timed["kernel"]),
            "device_ms": dev_ms,
            "plain_ms": statistics.median(timed["plain"])}
        print(f"[{tag}{'abc'[i]} bokeh timing] {label}: median of 10 (3 "
              f"warm-up), B = {BATCH} draws, on {smi}: "
              + median_line(timed).replace("rays/s", "draws/s")
              + f"; kernel on the card {card_text(dev_ms)} (profiler; bound "
              f"{bk_bound[0]:.4f} ms, {bk_bound[1]})", flush=True)
    return rows


def planes_phase(zt, bokeh_kernel, state, sizes, dev, smi, tag):
    """The retry-plane entry against its plain version (the eager hash and
    sampler), bit-equal, and two launches bit-equal: at the bench's planes
    and at the cell counts of the ragged batches, on the bench's image and
    on those of ``plane_images``; then its timings at the bench's planes
    (the other images by events alone)."""
    from zoic_tpu_torch.models import raytraced as rt_model

    image = state.bokeh
    pseed = SEED % (1 << 22) + rt_model.PLANE_SEED_OFFSET
    salts = (rt_model.SALT_P1, rt_model.SALT_P2)
    n_planes, bp = rt_model.plane_shape(MAX_TRIES, BATCH)
    n = n_planes * bp
    cells = [n] + [int(np.prod(rt_model.plane_shape(MAX_TRIES, b)))
                   for b in sizes]
    images = {"the bench's 64x64 disk": (image, True)}
    for label, pixels, shared in plane_images(zt):
        images[label] = (zt.bokeh.build(pixels).to(dev), shared)
    err, timed_more = 0.0, {}
    for label, (img, shared) in images.items():
        check(bokeh_kernel._plan(img, n, True, dev)[1] == shared,
              f"bokeh planes {label}: tables not in "
              f"{'shared' if shared else 'global'} memory")
        for c in cells:
            k = bokeh_kernel.planes_fused(img, c, pseed, *salts)
            k2 = bokeh_kernel.planes_fused(img, c, pseed, *salts)
            p = bokeh_kernel.planes_plain(img, c, pseed, *salts)
            torch.cuda.synchronize()
            bits = sum(int((a.view(torch.int32) != b.view(torch.int32)).sum())
                       for a, b in zip(k, p))
            check(bits == 0, f"bokeh planes {label}: {bits} bits differ at "
                  f"{c} cells")
            check(all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                      for a, b in zip(k, k2)),
                  f"bokeh planes {label}: two launches differ at {c} cells")
            err = max(err, *(float((a - b).abs().max()) for a, b in zip(k, p)))
        if img is not image:
            seeds = iter(range(pseed, pseed + 1000))
            timed_more[label] = statistics.median(time_ms(
                bokeh_kernel.planes_fused,
                lambda img=img: (img, n, next(seeds), *salts)))
    print(f"[{tag}d bokeh planes vs plain] {', '.join(images)}: {n_planes} x "
          f"{bp} cells and {', '.join(map(str, cells[1:]))} (ragged "
          f"batches): bit mismatches 0 (limit 0), two launches bit-equal; "
          f"kernel at {n} cells (events, median of 10, on {smi}): "
          + "; ".join(f"{k} {v:.4f} ms" for k, v in timed_more.items()),
          flush=True)
    seeds = iter(range(pseed, pseed + 1000))

    def fresh():
        return (image, n, next(seeds), *salts)

    timed = {"kernel": time_ms(bokeh_kernel.planes_fused, fresh),
             "plain": time_ms(bokeh_kernel.planes_plain, fresh)}
    k = bokeh_kernel.planes_fused(image, n, pseed, *salts)
    n_bytes = nbytes(*k, bokeh_kernel.packed_tables(image))
    pl_bound = bound(n_bytes, PLANE_OPS_PER_CELL * n)
    dev_ms = card_reading(
        lambda: bokeh_kernel.planes_fused(image, n, pseed, *salts),
        "bokeh_planes_kernel", statistics.median(timed["kernel"]),
        pl_bound[0], f"{tag}e")
    print(f"[{tag}e bokeh planes timing] median of 10 (3 warm-up), {n} "
          f"cells, on {smi}: " + "; ".join(
              f"{k} {statistics.median(ts):.4f} ms (min {min(ts):.4f}, max "
              f"{max(ts):.4f})" for k, ts in timed.items())
          + f"; kernel on the card {card_text(dev_ms)} (profiler; bound "
          f"{pl_bound[0]:.4f} ms, {pl_bound[1]}); the search before its "
          f"guide tables: {PLANES_EARLIER}", flush=True)
    return {"max_abs_err": err, "cells": n, "bytes": n_bytes,
            "bound": pl_bound,
            "kernel_ms": statistics.median(timed["kernel"]),
            "device_ms": dev_ms,
            "plain_ms": statistics.median(timed["plain"])}


def ragged_phase(zt, trace_kernel, name, state, cfg, sizes, dev, tag):
    """The raytraced kernel against its plain version at batches that do not
    fill a warp, a block or the persistent grid: tries and tir equal,
    payloads of live rays within the tolerance, on inputs, seed and (with
    image bokeh) retry planes made for each size; the kernel's finished
    rays against the plain epilogue on its rays, and the epilogue kernel
    against its plain version on those outputs, bit for bit."""
    from zoic_tpu_torch.models import raytraced as rt_model

    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    seed = (SEED + 4) % (1 << 22)
    worst = epi_err = 0.0
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
        finished_vs_plain(trace_kernel, name, args, kw, (ko, kd, kt, ktir),
                          state.exposure_control, cfg.max_tries,
                          f"{tag} {name} finished rays vs plain")
        epi_err = max(epi_err, epilogue_vs_plain(
            name, kt, ktir, ko, kd, state.exposure_control, cfg.max_tries,
            f"{tag} {name} epilogue vs plain")["max_abs_err"])
    print(f"[{tag} {name} ragged batches] B = {', '.join(map(str, sizes))}: "
          f"tries/tir equal to the plain version's, live max |d| "
          f"{worst:.3e} (limit {PAYLOAD_ATOL}); the finished rays and the "
          f"epilogue bit-equal", flush=True)
    return epi_err


def lane_use_phase(dev, smi, tag):
    """How full the warps are when they draw and trace: the camera kernels'
    counting builds on five raytraced cameras and the thin lens with
    vignetting, each held to the main build's outputs bit for bit."""
    from zoic_tpu_torch.tools import lane_use

    seed = SEED % (1 << 22)
    rows = {name: lane_use.raytraced_row(name, BATCH, seed, dev)
            for name in lane_use.RAYTRACED}
    rows["thinlens_vignette"] = lane_use.thinlens_row(BATCH, seed, dev)
    for i, (name, r) in enumerate(rows.items()):
        print(f"[{tag}.{i} lane use {name}] B = {BATCH}, on {smi}: "
              + ", ".join(f"{k} {v:.4f}" if isinstance(v, float)
                          else f"{k} {v}" for k, v in r.items()), flush=True)
        check(r["equal"], f"{name}: the counting build's outputs differ "
              "from the main build's")
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
    from zoic_tpu_torch.ops import circles_kernel

    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    sx, sy, lx, ly = draws(g, BATCH, dev)
    seed = (SEED + 3) % (1 << 22)
    out = {}
    for i, name in enumerate(zt.data.CAMERAS):
        cfg = raytraced_config(zt, name, bokeh_path)
        torch.cuda.synchronize()
        fits = circles_kernel.launches
        t0 = time.perf_counter()
        st = zt.compile_camera(cfg, dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        fits = circles_kernel.launches - fits
        check(fits == (3 if cfg.kolb_sampling_lut else 2),
              f"compile {name}: {fits} circle fit launches, not 3 with the "
              f"LUT (reach, pick, the smoothing's reach) or 2 without")
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
        print(f"[{tag}.{i} compile {name}] {secs:.2f} s, {fits} circle fit "
              f"launches; lens statics equal; "
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


def circles_phase(zt, dev, smi, tag):
    """The pre-check's circle fit on the headline's fit cover at the
    compile's shapes (32 keys x ``CIRCLES_N`` samples, traced on the card
    as the compile traces them): the kernel path of ``fit_circles`` and of
    the smoothing's ``reach_at`` bit-equal to their plain route
    (``fit_circles`` on CPU copies, whose reductions are ``reach_plain``
    and ``pick_plain``; ``reach_at_plain``), the fit's two entries, the
    whole kernel-path fit, the plain fit and its two reductions timed on
    the host clock (each ends in its read-back), and the three kernels'
    time on the card by torch.profiler, beside the bound: the reach's and
    the pick's FP64 operations (a subtract, a multiply, an add an
    (accepted sample, centre) and a (subsampled sample, centre)) at
    ``FP64_OPS_PER_S``, or the traces' bytes, whichever is larger."""
    from zoic_tpu_torch import pupil
    from zoic_tpu_torch.ops import circles_kernel as ck

    st = zt.load_state(zt.data.state_path(), device=dev)
    keys = st.lens.lut.keys
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    u = torch.rand((2, keys.shape[0], CIRCLES_N), generator=g, device=dev)
    lx, ly, ok = (t.contiguous() for t in pupil._cover_trace(
        st.lens, keys, u, "disk"))
    lxc, lyc, okc = (t.cpu() for t in (lx, ly, ok))
    okn = okc.numpy()
    n_keys = okn.shape[0]
    before = ck.launches
    got = ck.fit_circles(lx, ly, ok)
    want, plain_s = seconds(lambda: ck.fit_circles(lxc, lyc, okc))
    centres = np.stack([got[0], got[2]], 1)
    m2 = ck.reach_at(lx, ly, ok, centres)
    check(ck.launches == before + 3, "the circle fit and the smoothing's "
          "reach did not launch three entries")

    def same(a, b):
        return all(np.array_equal(np.asarray(x, np.float64).view(np.int64),
                                  np.asarray(y, np.float64).view(np.int64))
                   for x, y in zip(a, b))

    fit_equal = same(got, want)
    reach_equal = same([m2], [ck.reach_at_plain(lxc, lyc, okc, centres)])
    check(fit_equal and reach_equal, f"circle fit kernel path: fit "
          f"bit-equal {fit_equal}, smoothing reach bit-equal {reach_equal}")
    cand = np.linspace(-3.0, 3.0, ck.CIRCLE_CENTERS)
    negi, posi = np.where(cand <= 0.0)[0], np.where(cand >= 0.0)[0]
    stride = max(1, CIRCLES_N // ck.CIRCLE_SEL_SAMPLES)
    cand_t = torch.from_numpy(cand).to(dev)
    rk = np.sqrt(np.maximum(ck.reach(lx, ly, ok, cand_t), 0.0)) * 1.01 + 0.005
    calls = {
        "fit": lambda: ck.fit_circles(lx, ly, ok),
        "reach": lambda: ck.reach(lx, ly, ok, cand_t),
        "pick": lambda: ck.pick(lx, ly, rk ** 2, cand, negi, posi, stride),
        "reach_at": lambda: ck.reach_at(lx, ly, ok, centres),
    }
    host_ms = {}
    for name, fn in calls.items():
        fn()
        host_ms[name] = statistics.median(
            seconds(fn)[1] * 1e3 for _ in range(CIRCLES_ITERS))
    plain_ms = min(plain_s, seconds(
        lambda: ck.fit_circles(lxc, lyc, okc))[1]) * 1e3
    plain_entries_ms = {
        "reach_plain": seconds(lambda: ck.reach_plain(
            lxc, lyc, okc, torch.from_numpy(cand)))[1] * 1e3,
        "pick_plain": seconds(lambda: ck.pick_plain(
            lxc, lyc, rk ** 2, cand, negi, posi, stride))[1] * 1e3}
    records, _ = profile_window(calls["fit"], host=False)
    names = ("reach_kernel", "bits_kernel", "pair_kernel")
    card_us = {k: sum(r[1] for r in records if k in r[0]) / PROFILED_CALLS
               for k in names}
    n_records = sum(1 for r in records if any(k in r[0] for k in names))
    card_ms = (sum(card_us.values()) / 1e3
               if n_records == len(names) * PROFILED_CALLS else None)
    READINGS["taken" if card_ms is not None else "rejected"] += 1
    accepted = int(okn.sum())
    n_sub = -(-CIRCLES_N // stride)
    ops = 3.0 * cand.size * (accepted + n_keys * n_sub)
    by_ops = ops / FP64_OPS_PER_S * 1e3
    by_bytes = (lx.nbytes + ly.nbytes + ok.nbytes) / HBM_BYTES_PER_S * 1e3
    bound_ms, bound_by = max((by_ops, "operations"), (by_bytes, "bytes"))
    print(f"[{tag} circles] headline fit cover, {n_keys} keys x {CIRCLES_N} "
          f"samples, {accepted} accepted, pick stride {stride}: the kernel "
          f"path bit-equal to the plain fit and the smoothing's reach; host "
          f"ms (median of {CIRCLES_ITERS}, read-backs in) fit "
          f"{host_ms['fit']:.3f}, reach {host_ms['reach']:.3f}, pick "
          f"{host_ms['pick']:.3f}, smoothing reach {host_ms['reach_at']:.3f};"
          f" plain fit {plain_ms:.1f} ms (reach_plain "
          f"{plain_entries_ms['reach_plain']:.1f}, pick_plain "
          f"{plain_entries_ms['pick_plain']:.1f} over every key); card "
          + (f"{card_ms:.4f} ms a fit (" + ", ".join(
              f"{k} {v:.1f} us" for k, v in card_us.items()) + ")"
             if card_ms is not None else
             f"no reading ({n_records} records of "
             f"{len(names) * PROFILED_CALLS})")
          + f"; bound {bound_ms:.4f} ms ({bound_by}: {ops:.4g} FP64 "
          f"operations, {by_bytes:.4f} ms of bytes); on {smi}", flush=True)
    return {"ms": host_ms["fit"], "entries_ms": host_ms, "device_ms": card_ms,
            "card_us": card_us, "plain_ms": plain_ms,
            "plain_entries_ms": plain_entries_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "max_abs_err": 0.0}


def roofline_phase(rk, roofline, profiling, dev, smi, tag):
    """The op-rate microbenchmark kernel: each case against its plain
    version at the tool's default shape (bit-equal), each case's
    element-op rate beside its bound, the hand-written ``sqrt``, ``div``
    and ``recip`` against PyTorch's operations over every exponent and the
    specials (bit-equal), and the SM clock the card holds under ``fma``
    and ``div``."""
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
    x = torch.full((ns, tile, rk.LANES), 1.234, device=dev)
    plain_s = profiling.time_fn(
        lambda v: rk.roofline_plain("fma", v, grid, reps), lambda: (x,),
        iters=3, warmup=1, bursts=3, device=dev)["median"]
    print(f"[{tag}b roofline rates] {sms} SMs at {clock / 1e6:.0f} MHz, on "
          f"{smi}: " + "; ".join(
              f"{n} {r['rate'] / 1e12:.3f} Top/s ({r['ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms, {r['bound_ms'] / r['ms']:.1%})"
              for n, r in rows.items())
          + f"; plain fma {plain_s * 1e3:.4f} ms", flush=True)
    sweep = roofline.ieee_sweep(dev)
    print(f"[{tag}c roofline IEEE sweep] a = -0.0, 1 and 9 steps over "
          f"every pattern of [1, 4), 2^23 over all exponents and the "
          f"specials; div over {len(roofline.sweep_dividends())} dividends: "
          + "; ".join(
              f"{n} {r['operands']} compared, {r['mismatches']} differ from "
              f"torch{' ' + str(r['first']) if r['first'] else ''}"
              for n, r in sweep.items()) + " (limit 0)", flush=True)
    check(all(r["mismatches"] == 0 for r in sweep.values()),
          "the kernel's sqrt/div/recip differ from PyTorch's")
    clocks = {n: roofline.held_clock_mhz(n, dev) for n in ("fma", "div")}
    held = statistics.median(clocks["fma"])
    print(f"[{tag}d roofline clock] SM clock while the case runs "
          f"(nvidia-smi clocks.sm, MHz): " + "; ".join(
              f"{n} {v}" for n, v in clocks.items())
          + f"; the bounds take clocks.max.sm {clock / 1e6:.0f} MHz; at the "
          f"clock held under fma, {held:.0f} MHz, the shares are "
          + ", ".join(f"{n} {r['bound_ms'] * clock / 1e6 / held / r['ms']:.1%}"
                      for n, r in rows.items() if n in ("fma", "mul", "add",
                                                        "div"))
          + f"; on {smi}", flush=True)
    # the fma case's bound for the kernel table: its dispatch-bound time, or the
    # block read and the output written at the memory rate if longer
    ops_ms = rows["fma"]["bound_ms"]
    out_bytes = grid * tile * rk.LANES * x.element_size()
    bytes_ms = (nbytes(x) + out_bytes) / HBM_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)

    def fma():
        return rk.roofline_fused("fma", x, grid, reps)

    # the rows' times are bursts of back-to-back launches; the reading is
    # held to single wrapper calls
    dev_ms = card_reading(fma, "roofline_f32", events_ms(fma), bound_ms,
                          f"{tag}d")
    return {"rows": rows, "sweep": sweep, "clocks_mhz": clocks,
            "ms": rows["fma"]["ms"], "device_ms": dev_ms,
            "plain_ms": plain_s * 1e3, "bound_ms": bound_ms,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "max_abs_err": max(r["max_abs_err"] for r in rows.values())}


def bench_phase(trace_kernel, bokeh_kernel, rk, kind, tag):
    """``python -m zoic_tpu_torch.bench``'s headline at the full batch,
    iterations cut: its JSON line on a line of its own, checked, its
    bursts and their spread, and the launches of the path (the
    microbenchmark for the peak, the raytraced kernel for the rays)."""
    from zoic_tpu_torch import bench

    buf, err = io.StringIO(), io.StringIO()
    reset_counts(trace_kernel, bokeh_kernel, rk)
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
        bench.main(list(BENCH_ARGS))
    n_rt = trace_kernel.launches + trace_kernel.raytraced_rays_launches
    n_roof = rk.launches
    print(err.getvalue().rstrip(), flush=True)
    line = buf.getvalue().strip().splitlines()[-1]
    print(line, flush=True)
    res = json.loads(line)
    keys = ("metric", "value", "unit", "vs_baseline", "attempts_per_ray",
            "vignetted_frac", "peak_tops", "mfu", "device", "spread")
    check(all(k in res for k in keys), f"bench line lacks keys: {res}")
    check(res["device"] == kind, f"bench ran on {res['device']}")
    for k in ("value", "peak_tops", "mfu", "attempts_per_ray"):
        check(math.isfinite(res[k]) and res[k] > 0, f"bench {k} = {res[k]}")
    check(1.0 <= res["attempts_per_ray"] <= 3.0 and res["vignetted_frac"] < 0.01,
          "bench headline attempts/ray or vignetted fraction off")
    check(n_rt > 0 and n_roof > 0,
          f"bench path launches: raytraced {n_rt}, roofline {n_roof}")
    check(math.isfinite(res["spread"]) and res["spread"] >= 0.0,
          f"bench spread = {res['spread']}")
    print(f"[{tag} bench] {' '.join(BENCH_ARGS)}: {bench.BURSTS} bursts, "
          f"spread {res['spread']:.2%}; launches raytraced {n_rt}, "
          f"roofline {n_roof}, thinlens {trace_kernel.thinlens_rays_launches}, "
          f"bokeh {bokeh_kernel.launches}", flush=True)
    return {"launches": n_roof, "raytraced_launches": n_rt, "result": res}


def counts(trace_kernel, bokeh_kernel, rk) -> dict:
    from zoic_tpu_torch.ops import epilogue_kernel

    return {"raytraced": (trace_kernel.launches
                          + trace_kernel.raytraced_rays_launches),
            "thinlens": trace_kernel.thinlens_rays_launches,
            "bokeh": bokeh_kernel.launches,
            "bokeh_planes": bokeh_kernel.plane_launches,
            "roofline": rk.launches,
            "epilogue": epilogue_kernel.launches}


def only(launched: dict, **want) -> bool:
    """Whether ``launched`` holds ``want``'s counts and 0 for every other
    kernel."""
    return all(v == want.get(k, 0) for k, v in launched.items())


def add_counts(total: dict, more: dict) -> None:
    for k, v in more.items():
        total[k] = total.get(k, 0) + v


def events_ms(fn, warmup=2, iters=5) -> float:
    """Median milliseconds of ``fn()`` between two CUDA events."""
    return statistics.median(time_ms(lambda: fn(), lambda: (), warmup, iters))


def seconds(fn):
    """``(result, seconds)`` of ``fn()`` with the card synchronised."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def stats_lines(cam) -> list:
    """The lines ``cam.log_stats()`` writes to the ``zoic`` logger."""
    import logging

    lines = []
    handler = logging.Handler()
    handler.emit = lambda record: lines.append(record.getMessage())
    logger = logging.getLogger("zoic")
    level = logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        cam.log_stats()
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    return lines


def check_rays(name, rays, stats, n, full=True):
    for f in ("origin", "dir", "weight", "d_ody", "d_ddy"):
        check(bool(torch.isfinite(getattr(rays, f)).all()),
              f"{name}: rays.{f} not finite")
    check(rays.origin.shape == (n, 3), f"{name}: unexpected output shape")
    if full:
        check(int(stats.success) + int(stats.vignetted) == n,
              f"{name}: success + vignetted != {n}")


def camera_phase(zt, kernels, bokeh_path, dev, smi, tag):
    """``Camera`` and ``render`` on the headline at the bench's batch (a
    2048 x 1024 frame at 2 spp), checked against ``create_rays`` on the
    same frame samples and seed; then the thin-lens camera with image
    bokeh and vignetting, and the headline lens with image bokeh, through
    the same entry points."""
    trace_kernel, bokeh_kernel, rk = kernels
    spec = zt.FrameSpec(*FRAME)
    check(spec.n_samples == BATCH, "the frame is not the bench's batch")
    cfg = raytraced_config(zt, "headline")
    cam, compile_s = seconds(lambda: zt.Camera(cfg, dev))
    g = torch.Generator(device=dev).manual_seed(SEED)
    start = g.get_state()
    reset_counts(trace_kernel, bokeh_kernel, rk)
    rays, stats = zt.render.render_rays(cam.state, cfg, spec, generator=g)
    torch.cuda.synchronize()
    launched = counts(trace_kernel, bokeh_kernel, rk)
    check(launched["raytraced"] > 0, "render_rays: no raytraced launch")
    check_rays("render_rays", rays, stats, BATCH)
    g.set_state(start)
    samples = zt.render.frame_samples(spec, g)
    reset_counts(trace_kernel, bokeh_kernel, rk)
    again, stats1 = cam.create_rays(*samples, generator=g)
    flat, stats2 = cam.create_rays(*samples, seed=SEED % (1 << 22))
    torch.cuda.synchronize()
    add_counts(launched, counts(trace_kernel, bokeh_kernel, rk))
    check(bits_equal((rays.origin, rays.dir, rays.weight),
                     (again.origin, again.dir, again.weight)),
          "render_rays and create_rays on the same samples and seed differ")
    want = [int(getattr(stats1, f)) + int(getattr(stats2, f))
            for f in ("success", "vignetted", "tir")]
    totals = cam.stats_totals.tolist()
    check(cam.stats_totals.dtype == torch.int64 and totals == want,
          f"Camera totals {totals} != the calls' stats {want}")
    h, w = spec.height, spec.width
    # a batch that is not flat runs the kernel once, on the flattened
    # samples, and gives the flat call's rays in its shape
    reset_counts(trace_kernel, bokeh_kernel, rk)
    grid, _ = zt.create_rays(cam.state, cfg,
                             *(a.reshape(h, -1) for a in samples),
                             seed=SEED % (1 << 22))
    torch.cuda.synchronize()
    gc = counts(trace_kernel, bokeh_kernel, rk)
    add_counts(launched, gc)
    check(gc["raytraced"] == 1 and grid.dir.shape == (h, BATCH // h, 3),
          f"[H, W] batch: launches {gc}, shape {tuple(grid.dir.shape)}")
    check(bits_equal((flat.origin, flat.dir, flat.weight),
                     (grid.origin.reshape(-1, 3), grid.dir.reshape(-1, 3),
                      grid.weight.reshape(-1))),
          "an [H, W] batch and the flat call on the same samples differ")
    del grid
    img = zt.render.weight_image(spec, rays)
    check(img.shape == (h, w), f"weight_image shape {img.shape}")
    centre = float(img[h // 2 - 8:h // 2 + 8, w // 2 - 8:w // 2 + 8].mean())
    corners = max(float(img[r, c].mean()) for r in (slice(0, 16),
                                                    slice(-16, None))
                  for c in (slice(0, 16), slice(-16, None)))
    check(centre >= corners, f"centre {centre} darker than a corner {corners}")
    log_lines = stats_lines(cam)
    render_ms = events_ms(lambda: zt.render.render_rays(
        cam.state, cfg, spec, generator=g))
    samples_ms = events_ms(lambda: zt.render.frame_samples(spec, g))
    print(f"[{tag}a Camera + render headline] compile {compile_s:.2f} s; "
          f"{spec.width}x{spec.height} at {spec.spp} spp = {BATCH} rays: "
          f"success {int(stats.success)} vignetted {int(stats.vignetted)}; "
          f"render_rays == create_rays bit for bit; an [{h}, "
          f"{BATCH // h}] batch: one raytraced launch, the flat call's bits; "
          f"weight_image "
          f"{tuple(img.shape)}, centre {centre:.4f} corners max "
          f"{corners:.4f}; totals {totals} (int64, on the card); "
          f"log_stats: {' | '.join(' '.join(ln.split()) for ln in log_lines)}"
          f"; on {smi}: render_rays {render_ms:.4f} ms, frame_samples "
          f"{samples_ms:.4f} ms (CUDA events, median of 5)", flush=True)

    others = {}
    for name, ocfg in (
            ("thinlens_bokeh_vignette",
             thinlens_configs(zt, bokeh_path)["thinlens_bokeh_vignette"]),
            ("raytraced_bokeh_image",
             raytraced_config(zt, "raytraced_bokeh_image", bokeh_path))):
        ocam, osecs = seconds(lambda: zt.Camera(ocfg, dev))
        reset_counts(trace_kernel, bokeh_kernel, rk)
        orays, ostats = zt.render.render_rays(ocam.state, ocfg, spec,
                                              generator=g)
        torch.cuda.synchronize()
        oc = counts(trace_kernel, bokeh_kernel, rk)
        add_counts(launched, oc)
        check_rays(name, orays, ostats, BATCH)
        kernel = "thinlens" if name.startswith("thin") else "raytraced"
        check(oc[kernel] > 0 and oc["bokeh"] > 0,
              f"{name}: launches {oc}")
        if kernel == "raytraced":
            check(oc["bokeh_planes"] > 0, f"{name}: no plane launch")
        ms = events_ms(lambda: zt.render.render_rays(ocam.state, ocfg, spec,
                                                     generator=g))
        others[name] = ocam
        print(f"[{tag}{'bc'[len(others) - 1]} Camera + render {name}] "
              f"compile {osecs:.2f} s; launches {oc}; success "
              f"{int(ostats.success)} vignetted {int(ostats.vignetted)}; on "
              f"{smi}: render_rays {ms:.4f} ms (CUDA events, median of 5)",
              flush=True)
    return {"cam": cam, "cfg": cfg, "bokeh_cam": others["raytraced_bokeh_image"],
            "launches": launched, "compile_s": compile_s,
            "render_ms": render_ms, "frame_samples_ms": samples_ms}


PROFILE_LEAVES = ("keys", "c0", "c1", "c2", "c4", "poly", "poly_scale")


def update_phase(zt, kernels, cam, cfg, bokeh_cam, dev, smi, tag):
    """``Camera.update`` on the card: a bokeh-only change keeps the lens
    object; an exposure change scales the weights by exactly 1 + e^2; a
    focal change recompiles, and returning to the original focal gives the
    first compile's LUT and pre-check leaves bit for bit."""
    trace_kernel, bokeh_kernel, rk = kernels
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke")
    other = os.path.join(root, "bokeh_disk48.npy")
    np.save(other, zt.data.bokeh_disk(48))
    lens_b = bokeh_cam.state.lens
    bokeh_cam.update(bokeh_cam.config.replace(bokeh_path=other))
    check(bokeh_cam.state.lens is lens_b and bokeh_cam.state.bokeh.width == 48,
          "a bokeh-only update recompiled the lens or kept the image")

    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    s = draws(g, BATCH, dev)
    seed = (SEED + 7) % (1 << 22)
    reset_counts(trace_kernel, bokeh_kernel, rk)
    before, _ = cam.create_rays(*s, seed=seed)
    e = 0.5
    cam.update(cfg.replace(exposure_control=e))
    after, _ = cam.create_rays(*s, seed=seed)
    torch.cuda.synchronize()
    launched = counts(trace_kernel, bokeh_kernel, rk)
    e2 = torch.tensor(e, dtype=torch.float32, device=dev) ** 2
    check(bits_equal((after.weight,), (before.weight * (1.0 + e2),)),
          "an exposure update did not scale the weights by 1 + e^2")

    first = cam.state.lens
    _, s_focal = seconds(lambda: cam.update(cam.config.replace(
        focal_length=5.5)))
    check(cam.state.lens is not first
          and float(cam.state.lens.origin_shift) != float(first.origin_shift),
          "a focal update did not recompile")
    _, s_back = seconds(lambda: cam.update(cam.config.replace(
        focal_length=cfg.focal_length)))
    lut_equal = bits_equal(
        [getattr(cam.state.lens.lut, f.name)
         for f in dataclasses.fields(first.lut)],
        [getattr(first.lut, f.name) for f in dataclasses.fields(first.lut)])
    prof_equal = bits_equal(
        [getattr(cam.state.lens.profile, f) for f in PROFILE_LEAVES],
        [getattr(first.profile, f) for f in PROFILE_LEAVES])
    check(lut_equal and prof_equal,
          "returning to the original focal did not reproduce the LUT and "
          "pre-check leaves")
    print(f"[{tag} Camera.update] bokeh-only change keeps the lens object; "
          f"exposure {e} scales the weights by exactly {float(1 + e2)}; "
          f"focal 5.0 -> 5.5 recompile {s_focal:.2f} s, -> 5.0 recompile "
          f"{s_back:.2f} s, LUT and pre-check leaves bit-equal to the first "
          f"compile's; on {smi}", flush=True)
    cam.update(cfg)
    return {"launches": launched, "recompile_s": [s_focal, s_back]}


def state_io_phase(zt, kernels, cam, cfg, dev, smi, tag):
    """A saved and reloaded state gives the same bits; ``cached_compile``
    compiles once and then loads, one file in its directory."""
    import shutil

    from zoic_tpu_torch.io import state as state_io

    trace_kernel, bokeh_kernel, rk = kernels
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke")
    path = os.path.join(root, "headline_state.npz")
    state_io.save(path, cam.state)
    back = state_io.load(path, device=dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    s = draws(g, BATCH, dev)
    seed = (SEED + 8) % (1 << 22)
    reset_counts(trace_kernel, bokeh_kernel, rk)
    r1, _ = zt.create_rays(cam.state, cfg, *s, seed=seed)
    r2, _ = zt.create_rays(back, cfg, *s, seed=seed)
    torch.cuda.synchronize()
    launched = counts(trace_kernel, bokeh_kernel, rk)
    check(bits_equal((r1.origin, r1.dir, r1.weight),
                     (r2.origin, r2.dir, r2.weight)),
          "a saved and reloaded state gives other rays")
    cache = os.path.join(root, "cache")
    shutil.rmtree(cache, ignore_errors=True)
    st1, s_compile = seconds(lambda: state_io.cached_compile(cfg, cache, dev))
    st2, s_load = seconds(lambda: state_io.cached_compile(cfg, cache, dev))
    files = os.listdir(cache)
    check(len(files) == 1, f"the cache holds {files}")
    check(bits_equal((st1.lens.lut.max_scale, st1.lens.profile.c0),
                     (st2.lens.lut.max_scale, st2.lens.profile.c0)),
          "the cached state differs from the compiled one")
    print(f"[{tag} save / load / cached_compile] reloaded state gives the "
          f"same bits at B = {BATCH}; cached_compile: first (a compile) "
          f"{s_compile:.2f} s, second (a load) {s_load:.3f} s, {len(files)} "
          f"file ({os.path.getsize(os.path.join(cache, files[0]))} B); on "
          f"{smi}", flush=True)
    return {"launches": launched, "compile_s": s_compile, "load_s": s_load}


def eager_phase(zt, kernels, state, dev, smi, tag):
    """The exact eager path (``impl="jnp"``) on the headline at the bench's
    batch against the kernel: the first attempt (``max_tries=0``) and the
    full budget's distributions; then the tessar's spot-RMS gradient by
    autograd on the card against the CPU's."""
    trace_kernel, bokeh_kernel, rk = kernels
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    s = draws(g, BATCH, dev)
    seed = (SEED + 9) % (1 << 22)
    out = {}
    for budget in (0, MAX_TRIES):
        cfg = raytraced_config(zt, "headline").replace(max_tries=budget)
        ecfg = cfg.replace(impl="jnp")
        reset_counts(trace_kernel, bokeh_kernel, rk)
        er, es = zt.create_rays(state, ecfg, *s, seed=seed)
        torch.cuda.synchronize()
        check(trace_kernel.launches + trace_kernel.raytraced_rays_launches
              == 0, "impl='jnp' launched a kernel")
        kr, ks = zt.create_rays(state, cfg, *s, seed=seed)
        torch.cuda.synchronize()
        check_rays(f"eager max_tries {budget}", er, es, BATCH)
        eok, kok = er.weight > 0, kr.weight > 0
        agree = float((eok == kok).float().mean())
        both = eok & kok
        err = max(float((er.origin - kr.origin)[both].abs().max()),
                  float((er.dir - kr.dir)[both].abs().max()))
        att = [1.0 + int(st.tries_total) / BATCH for st in (es, ks)]
        vig = [int(st.vignetted) / BATCH for st in (es, ks)]
        if budget == 0:
            check(agree >= 0.9999, f"eager ok mask agrees on {agree:.6f}")
            check(err <= PAYLOAD_ATOL, f"eager payloads differ by {err}")
        else:
            check(abs(att[0] - att[1]) <= 0.01 * att[1],
                  f"eager attempts/ray {att[0]} vs kernel {att[1]}")
            check(abs(vig[0] - vig[1]) <= 0.001,
                  f"eager vignetted {vig[0]} vs kernel {vig[1]}")
        e_ms = events_ms(lambda: zt.create_rays(state, ecfg, *s, seed=seed),
                         warmup=1, iters=3)
        k_ms = events_ms(lambda: zt.create_rays(state, cfg, *s, seed=seed),
                         warmup=1, iters=3)
        out[budget] = {"agree": agree, "err": err, "attempts": att,
                       "vignetted": vig, "eager_ms": e_ms, "kernel_ms": k_ms}
        first = (f"ok masks agree on {agree:.6f}, live max |d| {err:.3e} "
                 f"(limits 0.9999, {PAYLOAD_ATOL}); " if budget == 0 else "")
        print(f"[{tag}{'ab'[budget > 0]} eager path, max_tries {budget}] "
              f"B = {BATCH}: {first}attempts/ray eager {att[0]:.6f} kernel "
              f"{att[1]:.6f}; vignetted eager {vig[0]:.6f} kernel "
              f"{vig[1]:.6f}; on {smi}: create_rays eager {e_ms:.4f} ms, "
              f"kernel {k_ms:.4f} ms (CUDA events, median of 3)", flush=True)

    tcfg = zt.CameraConfig(
        lens_model=zt.LensModel.RAYTRACED,
        lens_data_path=zt.data.lens_path("tessar_f2.8"),
        focal_length=5.0, fstop=2.8, focal_distance=100.0,
        kolb_sampling_lut=False, pupil_precheck=False)
    u = torch.from_numpy(np.random.default_rng(0).uniform(
        size=(2, 1024)).astype(np.float32))
    from zoic_tpu_torch.examples.lens_optimization import spot_rms

    grads = []
    for d in ("cpu", dev):
        lens = zt.compile_camera(tcfg, d).lens
        c = lens.curvature.detach().clone().requires_grad_(True)
        (gc,) = torch.autograd.grad(spot_rms(lens, c, u.to(d)), c)
        grads.append(gc.cpu())
    rel = float(torch.linalg.norm(grads[1] - grads[0])
                / torch.linalg.norm(grads[0]))
    check(bool(torch.isfinite(grads[1]).all())
          and float(grads[1].abs().max()) > 0.0, "the card's gradient")
    check(rel <= 1e-3, f"the card's gradient is {rel:.2e} off the CPU's")
    print(f"[{tag}c autograd] tessar spot-RMS gradient on the card finite "
          f"and non-zero, {rel:.2e} relative to the CPU's (limit 1e-3)",
          flush=True)
    return {"launches": {}, "rows": out, "grad_rel": rel}


def sharding_phase(zt, kernels, state, kind, dev, smi, tag):
    """Data parallelism: a mesh of one card equals the unsharded call bit
    for bit at the full budget; two shards on the card equal it at
    ``max_tries=0``, sum their stats to B and repeat their bits; then the
    bench's headline with ``--mesh``."""
    from zoic_tpu_torch import bench
    from zoic_tpu_torch.parallel import sharding

    trace_kernel, bokeh_kernel, rk = kernels
    g = torch.Generator(device=dev).manual_seed(SEED + 10)
    s = draws(g, BATCH, dev)
    seed = (SEED + 10) % (1 << 22)
    cfg = raytraced_config(zt, "headline")
    mesh = sharding.make_mesh()
    reset_counts(trace_kernel, bokeh_kernel, rk)
    rays, stats = zt.create_rays(state, cfg, *s, seed=seed)
    srays, sstats = sharding.create_rays_sharded(mesh, state, cfg, *s,
                                                 seed=seed)
    cfg0 = cfg.replace(max_tries=0)
    mesh2 = sharding.make_mesh([dev, dev])
    one, _ = zt.create_rays(state, cfg0, *s, seed=seed)
    two, tstats = sharding.create_rays_sharded(mesh2, state, cfg0, *s,
                                               seed=seed)
    two_again, _ = sharding.create_rays_sharded(mesh2, state, cfg0, *s,
                                                seed=seed)
    torch.cuda.synchronize()
    launched = counts(trace_kernel, bokeh_kernel, rk)
    check(bits_equal([getattr(rays, f) for f in ("origin", "dir", "weight",
                                                 "d_ody", "d_ddy")],
                     [getattr(srays, f) for f in ("origin", "dir", "weight",
                                                  "d_ody", "d_ddy")])
          and int(stats.tries_total) == int(sstats.tries_total),
          "a mesh of one card differs from the unsharded call")
    ok = one.weight > 0
    check(torch.equal(ok, two.weight > 0)
          and bits_equal((one.dir[ok], one.origin[ok]),
                         (two.dir[ok], two.origin[ok])),
          "two shards differ from the unsharded first attempt")
    check(int(tstats.success) + int(tstats.vignetted) == BATCH,
          "two shards' stats do not sum to B")
    check(bits_equal((two.dir, two.origin, two.weight),
                     (two_again.dir, two_again.origin, two_again.weight)),
          "two runs of the two-shard mesh differ")
    print(f"[{tag}a sharding] make_mesh() = {[str(d) for d in mesh.devices]}"
          f": equal to the unsharded call bit for bit at max_tries "
          f"{MAX_TRIES}; two shards on {dev} equal it at max_tries 0, stats "
          f"sum to {BATCH}, two runs bit-equal", flush=True)

    buf = io.StringIO()
    reset_counts(trace_kernel, bokeh_kernel, rk)
    with contextlib.redirect_stdout(buf):
        bench.main([*BENCH_ARGS, "--mesh"])
    add_counts(launched, counts(trace_kernel, bokeh_kernel, rk))
    line = buf.getvalue().strip().splitlines()[-1]
    res = json.loads(line)
    check(res["device"] == kind and math.isfinite(res["value"])
          and res["value"] > 0, f"bench --mesh: {res}")
    print(line, flush=True)
    print(f"[{tag}b bench --mesh] {' '.join(BENCH_ARGS)} --mesh on "
          f"{mesh.size} card(s): {res['metric']} {res['value']:.4e} rays/s, "
          f"attempts/ray {res['attempts_per_ray']:.6f}, on {smi}", flush=True)
    return {"launches": launched, "mesh_rays_per_sec": res["value"],
            "metric": res["metric"]}


def diag_phase(zt, kernels, bokeh_path, dev, smi, tag):
    """The diagnostics: ``Camera`` in draw mode at the reference's
    ``draw_stride`` on phase 27's frame samples, the headline and the thin
    lens with bokeh and vignetting, two calls each: one camera kernel
    launch a call, the draw-off call's rays bit for bit, 42 taped rays a
    call, the card's tape against the same tape on the CPU from the same
    rays, the ``draw.zoic`` written from the card's and the CPU's tapes
    (headers byte-equal, RAYS read back); then the exit-pupil coverage on
    a 3 x 3 film grid against the CPU on the same uniforms, and the
    aperture self-test dump at the reference's sizes.  PNGs are drawn only
    where matplotlib is installed; everything else runs either way."""
    from zoic_tpu_torch.diag import dump, pupilplot, session, tape

    trace_kernel, bokeh_kernel, rk = kernels
    has_mpl = session.can_render()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke", "diag")
    spec = zt.FrameSpec(*FRAME)
    samples = zt.render.frame_samples(
        spec, torch.Generator(device=dev).manual_seed(SEED))
    seeds = (SEED % (1 << 22), (SEED + 1) % (1 << 22))
    n_taped = samples[0][::DRAW_STRIDE].numel()
    check(n_taped == TAPED_RAYS, f"{n_taped} taped rays of {BATCH}")
    launched, out = {}, {}
    for i, (name, cfg) in enumerate((
            ("headline", raytraced_config(zt, "headline")),
            ("thinlens_bokeh_vignette",
             thinlens_configs(zt, bokeh_path)["thinlens_bokeh_vignette"]))):
        drawn = cfg.replace(debug=zt.DebugOptions(draw=True,
                                                  draw_stride=DRAW_STRIDE))
        cam, compile_s = seconds(lambda: zt.Camera(drawn, dev))
        reset_counts(trace_kernel, bokeh_kernel, rk)
        calls = [cam.create_rays(*samples, seed=s) for s in seeds]
        torch.cuda.synchronize()
        c = counts(trace_kernel, bokeh_kernel, rk)
        add_counts(launched, c)
        raytraced = cfg.lens_model is zt.LensModel.RAYTRACED
        kernel = "raytraced" if raytraced else "thinlens"
        check(c[kernel] == len(seeds) and (c["bokeh"] > 0) == cfg.use_image,
              f"{name} draw mode: launches {c}")
        check(len(cam._draw_segments) == len(seeds),
              f"{name}: {len(cam._draw_segments)} tapes of {len(seeds)} calls")
        cpu_state = cam.state.to("cpu")
        cpu_segs, err = [], [0.0, 0.0]
        for (rays, stats), s, segs in zip(calls, seeds, cam._draw_segments):
            check_rays(f"{name} draw mode", rays, stats, BATCH)
            off, _ = zt.create_rays(cam.state, cfg, *samples, seed=s)
            check(bits_equal([getattr(rays, f) for f in RAY_FIELDS],
                             [getattr(off, f) for f in RAY_FIELDS]),
                  f"{name}: draw mode changed the rays")
            if raytraced:
                want = tape.raytraced_tape(
                    cpu_state, drawn,
                    *(a[::DRAW_STRIDE].cpu() for a in samples), stride=1)
            else:
                want = tape.thinlens_tape(
                    cpu_state, None, None, rays.origin[::DRAW_STRIDE].cpu(),
                    rays.dir[::DRAW_STRIDE].cpu())
                check(len(segs) == n_taped and np.array_equal(segs, want),
                      f"{name}: the thin-lens tape differs from the CPU's")
            hit, rel = tape.segment_errors(segs, want)
            check(hit <= TAPE_ATOL and rel <= TAPE_EXIT_RTOL,
                  f"{name}: tape vs CPU hit {hit:.3e}, exit {rel:.3e}")
            err = [max(err[0], hit), max(err[1], rel)]
            cpu_segs.append(want)
        card_dir, cpu_dir = (os.path.join(root, name, d)
                             for d in ("card", "cpu"))
        texts = []
        for d, st, sg in ((card_dir, cam.state, cam._draw_segments),
                          (cpu_dir, cpu_state, cpu_segs)):
            with open(session.write_dump(st, cam.config, sg, d)) as f:
                texts.append(f.read())
        header = texts[0][:texts[0].index("RAYS{")]
        check(header == texts[1][:texts[1].index("RAYS{")],
              f"{name}: the dump's header differs from the CPU's")
        segs = np.concatenate(cam._draw_segments)
        back = dump.parse(texts[0])["RAYS"]
        check(back.shape == segs.shape
              and np.allclose(back, segs, rtol=0, atol=1e-9),
              f"{name}: draw.zoic does not give back the tape")
        png = "not drawn (no matplotlib)"
        if has_mpl:
            png = session.write_and_render(cam.state, cam.config,
                                           cam._draw_segments, card_dir)
            png = f"{os.path.basename(png)} {os.path.getsize(png)} B"
        rays = calls[0][0]
        off_ms = events_ms(lambda: zt.create_rays(cam.state, cfg, *samples,
                                                  seed=seeds[0]))
        on_ms = events_ms(lambda: cam.create_rays(*samples, seed=seeds[0]))
        tape_ms = events_ms(lambda: tape.call_tape(cam.state, drawn,
                                                   *samples, rays))
        # the same tape of the same rays on the host, and the tape's
        # kernels on the card per call (the profiler)
        cpu_args = ((*(a[::DRAW_STRIDE].cpu() for a in samples), rays)
                    if raytraced else
                    (*samples, type(rays)(*(getattr(rays, f)[::DRAW_STRIDE]
                                            .cpu() for f in RAY_FIELDS))))
        host_cfg = drawn.replace(debug=zt.DebugOptions(
            draw=True, draw_stride=1))
        cpu_ms = statistics.median(
            seconds(lambda: tape.call_tape(cpu_state, host_cfg,
                                           *cpu_args))[1] * 1e3
            for _ in range(5))
        tape_kernels = kernel_count(
            lambda: tape.call_tape(cam.state, drawn, *samples, rays),
            f"{tag}{'ab'[i]} diag {name} tape")
        out[name] = {"create_rays_ms": off_ms, "draw_create_rays_ms": on_ms,
                     "tape_ms": tape_ms, "cpu_tape_ms": cpu_ms,
                     "tape_kernels": tape_kernels, "segments": len(segs),
                     "compile_s": compile_s}
        print(f"[{tag}{'ab'[i]} diag {name}] Camera(debug.draw, draw_stride "
              f"{DRAW_STRIDE}), {len(seeds)} calls of {BATCH} rays: launches "
              f"{c}; rays bit-equal to draw off; {n_taped} taped rays a "
              f"call, {len(segs)} segments; card vs CPU tape: hits "
              f"{err[0]:.3e} abs, exits {err[1]:.3e} rel; draw.zoic header "
              f"{len(header)} B equal to the CPU's, RAYS read back; PNG "
              f"{png}; on {smi}: create_rays {off_ms:.4f} ms, with draw "
              f"{on_ms:.4f} ms, tape {tape_ms:.4f} ms (CUDA events around "
              f"host-synchronised calls, median of 5), "
              f"{'no reading' if tape_kernels is None else tape_kernels} "
              f"kernels on the card a tape (profiler); the same tape on the "
              f"host CPU {cpu_ms:.4f} ms (median of 5)", flush=True)

    lens = zt.load_state(zt.data.state_path(), device=dev).lens
    cpu_lens = lens.to("cpu")
    g = torch.Generator(device=dev).manual_seed(SEED + 33)
    cov = []
    for fx in (-1.8, 0.0, 1.8):
        for fy in (-1.8, 0.0, 1.8):
            u = torch.rand((2, COVERAGE_N), generator=g, device=dev)
            a = pupilplot.coverage(lens, (fx, fy), COVERAGE_N, uniforms=u)
            b = pupilplot.coverage(cpu_lens, (fx, fy), COVERAGE_N,
                                   uniforms=u.cpu())
            check(abs(a - b) <= 1.0 / COVERAGE_N,
                  f"coverage at ({fx}, {fy}): card {a} vs CPU {b}")
            cov.append(a)
    path = os.path.join(root, "testApertures.zoic")
    _, self_s = seconds(lambda: pupilplot.write_selftest_dump(
        lens, path, **SELFTEST))
    gt, ss = dump.parse_aperture_test(path)
    n_pos = (2 * SELFTEST["film_grid"] + 1) ** 2
    check(len(gt) == n_pos and len(ss) == n_pos
          and all(r.shape == (SELFTEST["n_ss"], 2) for r in ss)
          and len(gt[n_pos // 2]) > 0,
          f"self-test dump: {len(gt)} GT and {len(ss)} SS rows")
    png = "not drawn (no matplotlib)"
    if has_mpl:
        p = os.path.join(root, "pupil.png")
        pupilplot.render_comparison(lens, p, film_grid=1)
        png = f"pupil.png {os.path.getsize(p)} B"
    print(f"[{tag}c diag pupil] coverage on a 3 x 3 film grid at n = "
          f"{COVERAGE_N}: {', '.join(f'{c:.4f}' for c in cov)}, equal to "
          f"the CPU's on the same uniforms within 1/n; self-test dump "
          f"(film_grid {SELFTEST['film_grid']}, {SELFTEST['n_gt']} / "
          f"{SELFTEST['n_ss']} draws) {len(gt)} GT + {len(ss)} SS rows in "
          f"{self_s:.2f} s, centre GT {len(gt[n_pos // 2])} points; PNG "
          f"{png}", flush=True)
    return {"launches": launched, "cameras": out, "coverage": cov,
            "selftest_s": self_s, "matplotlib": has_mpl}



def examples_phase(zt, kernels, dev, smi, tag):
    """The two examples on the card.  The render demo on every lens of
    ``zt.data.LENSES`` at its defaults (the camera compiled with a
    20,000-sample LUT and the pre-check, a 192 x 128 x 4 frame through
    ``render.render_rays``, the tape of 4,096 draws at stride 16, the dump,
    the coverage at 25 film points; PNGs only with matplotlib) into
    ``build/chip_smoke/examples``: one raytraced launch each, finite rays,
    the render's time by CUDA events.  On the lenses no shipped camera
    uses, the kernel against its plain version on the frame's samples, and
    its time at ``BATCH`` beside its attempts/ray and its bound.  Then the
    lens optimisation: 60 Adam steps on the card, its first losses against
    the same run on the CPU (the card's lens and uniforms copied there),
    and the share of the perturbation it takes back."""
    from zoic_tpu_torch.examples import lens_optimization, render_demo
    from zoic_tpu_torch.models import raytraced as rt_model

    trace_kernel, bokeh_kernel, rk = kernels
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "chip_smoke", "examples")
    shipped = {c.lens for c in zt.data.CAMERAS.values()}
    spec = render_demo.SPEC
    n_points = (2 * render_demo.FILM_GRID + 1) ** 2
    frame_limit = spec.n_samples * MAX_TRIES_MISMATCH // BATCH
    launched, lenses = {}, {}
    for name in sorted(zt.data.LENSES):
        reset_counts(trace_kernel, bokeh_kernel, rk)
        with contextlib.redirect_stdout(io.StringIO()):
            res = render_demo.run(name, out_dir, dev)
        torch.cuda.synchronize()
        n = counts(trace_kernel, bokeh_kernel, rk)
        add_counts(launched, n)
        check(only(n, raytraced=1),
              f"demo {name}: launches {n}, not one raytraced launch")
        check_rays(f"demo {name}", res.rays, res.stats, spec.n_samples)
        check(res.image.shape == (spec.height, spec.width)
              and bool(torch.isfinite(res.image).all()),
              f"demo {name}: weight image")
        check(len(res.segments) > 0 and bool(np.isfinite(res.segments).all())
              and os.path.getsize(res.dump_path) > 0,
              f"demo {name}: tape or dump")
        cover = list(res.coverage.values())
        check(len(cover) == n_points and all(0.0 <= c <= 1.0 for c in cover),
              f"demo {name}: coverage {cover}")
        st, cfg = res.camera.state, res.camera.config
        g = torch.Generator(device=dev).manual_seed(0)
        render_ms = events_ms(
            lambda: zt.render.render_rays(st, cfg, spec, g))
        row = {"compile_s": res.compile_s, "render_ms": render_ms,
               "vignetted_pct": float(res.stats.vignetted_percent()),
               "tir": int(res.stats.tir),
               "attempts": 1.0 + int(res.stats.tries_total) / spec.n_samples,
               "segments": len(res.segments), "coverage": cover,
               "not_drawn": len(res.not_drawn)}
        print(f"[{tag}a demo {name}] compile {res.compile_s:.2f} s; "
              f"render_rays {spec.width}x{spec.height}x{spec.spp} "
              f"{render_ms:.4f} ms (CUDA events, median of 5); vignetted "
              f"{row['vignetted_pct']:.2f}%, tir {row['tir']}, attempts/ray "
              f"{row['attempts']:.4f}; {row['segments']} segments; "
              f"{len(res.written)} files, {len(res.not_drawn)} PNGs not "
              f"drawn; coverage at {n_points} film points "
              + " ".join(f"{c:.4f}" for c in cover), flush=True)
        if name not in shipped:
            sx, sy, lu, lv = zt.render.frame_samples(
                spec, torch.Generator(device=dev).manual_seed(0))
            seed = SEED % (1 << 22)
            u1, u2, kw = rt_model.kernel_inputs(st, cfg, lu, lv, seed)
            args = (st.lens, sx, sy, u1, u2, st.sensor_width, seed)
            cmp = kernel_vs_plain(trace_kernel, name, args, kw,
                                  cfg.max_tries,
                                  f"{tag}a demo {name} kernel vs plain",
                                  frame_limit)
            fresh = fresh_inputs(
                st, cfg, torch.Generator(device=dev).manual_seed(SEED + 34),
                dev)
            big = fresh()
            out = trace_kernel.raytraced_fused(*big[:7], **big[7])
            ms = statistics.median(time_ms(
                lambda *a: trace_kernel.raytraced_fused(*a[:7], **a[7]),
                fresh))
            tries = out[2]
            attempts = 1.0 + int(tries.sum()) / BATCH
            success = int((tries <= cfg.max_tries).sum())
            rt_bound = bound(nbytes(*big[1:5], *out),
                             raytraced_ops(tries, cfg.max_tries))
            card_ms = card_reading(
                lambda: trace_kernel.raytraced_fused(*big[:7], **big[7]),
                "raytraced_kernel", ms, rt_bound[0], f"{tag}a demo {name}")
            row.update(mismatches=cmp["mismatches"],
                       max_abs_err=cmp["max_abs_err"], kernel_ms=ms,
                       device_ms=card_ms, batch_attempts=attempts,
                       bound_ms=rt_bound[0], bound_by=rt_bound[1])
            print(f"[{tag}a demo {name} kernel at B = {BATCH}] on {smi}: "
                  f"{ms:.4f} ms (CUDA events, median of 10), "
                  f"{card_text(card_ms)} on the card (profiler); attempts/ray "
                  f"{attempts:.4f}, "
                  f"success {success}; bound {rt_bound[0]:.4f} ms "
                  f"({rt_bound[1]})", flush=True)
        lenses[name] = row

    reset_counts(trace_kernel, bokeh_kernel, rk)
    lo = lens_optimization
    lens, opt_s = seconds(lambda: zt.compile_camera(lo.config(), dev).lens)
    u = lo.uniforms(dev)
    card, card_s = seconds(lambda: lo.run(dev, lens=lens, u=u))
    n = counts(trace_kernel, bokeh_kernel, rk)
    check(only(n), f"the lens optimisation launched {n}")
    cpu = lo.run("cpu", steps=EXAMPLE_LOSSES, lens=lens.to("cpu"),
                 u=u.cpu())
    rel = max(abs(a - b) / abs(b) for a, b in
              zip(card.losses[:EXAMPLE_LOSSES], cpu.losses))
    check(len(card.losses) == lo.STEPS
          and all(math.isfinite(x) for x in card.losses),
          "the lens optimisation's losses")
    check(rel <= EXAMPLE_LOSSES_RTOL,
          f"the card's first losses are {rel:.2e} off the CPU's")
    check(card.recovered >= EXAMPLE_MIN_RECOVERED,
          f"the lens optimisation recovered {card.recovered:.3f}")
    print(f"[{tag}b lens optimisation] {lo.LENS}, {lo.STEPS} Adam steps on "
          f"the card: spot RMS designed {card.designed:.6f} cm, perturbed "
          f"{card.perturbed:.6f}, steps 0-50 "
          + " ".join(f"{x:.6f}" for x in card.losses[::lo.REPORT_EVERY])
          + f", final {card.final:.6f} (recovered {card.recovered * 100:.1f}%"
          f", limit {EXAMPLE_MIN_RECOVERED * 100:.0f}%); first "
          f"{EXAMPLE_LOSSES} losses {rel:.2e} relative to the CPU's (limit "
          f"{EXAMPLE_LOSSES_RTOL}); compile {opt_s:.2f} s, steps "
          f"{card_s:.2f} s; no kernel launched", flush=True)
    return {"launches": launched, "lenses": lenses,
            "optimisation": {"designed": card.designed,
                             "perturbed": card.perturbed,
                             "final": card.final,
                             "recovered": card.recovered,
                             "cpu_rel": rel, "steps_s": card_s}}


def entry_phase(zt, kernels, dev, smi, tag):
    """The entry points, ``zoic_tpu_torch.entry``, on the card:
    ``entry()``'s forward step called twice on its example arguments, its
    outputs of the right shapes, finite, bit-equal between the two calls
    and to ``create_rays`` called directly on the same state, samples and
    seed; then ``dryrun_multichip`` over every visible card, each pass's
    stats summing to its rays and the kernel pass launching the raytraced
    kernel once a card.  Then the raytraced kernel against its plain
    version on the inputs this path gave it (not counted as launches of
    the path): the entry's 65,536 samples on its state, and each card's
    shard of the dry run's kernel pass on the dry run's state, each held
    to the gate's share of mismatched tries (0.01% of its rays, rounded
    up)."""
    from zoic_tpu_torch import entry
    from zoic_tpu_torch.models import raytraced as rt_model
    from zoic_tpu_torch.parallel import sharding

    trace_kernel, bokeh_kernel, rk = kernels
    t0 = time.perf_counter()
    reset_counts(trace_kernel, bokeh_kernel, rk)
    (fn, args), compile_s = seconds(entry.entry)
    state, sx, sy, lx, ly, seed = args
    outs = [fn(*args) for _ in range(2)]
    rays, stats = zt.create_rays(state, entry.config(), sx, sy, lx, ly,
                                 seed=seed)
    torch.cuda.synchronize()
    launched = counts(trace_kernel, bokeh_kernel, rk)
    n = entry.ENTRY_RAYS
    shapes = [tuple(o.shape) for o in outs[0]]
    check(shapes == [(n, 3), (n, 3), (n,), ()], f"entry: shapes {shapes}")
    check(all(o.device == dev and bool(torch.isfinite(o).all())
              for o in outs[0]), "entry: outputs not finite on the card")
    check(bits_equal(outs[0], outs[1]), "entry: two calls of fn differ")
    check(bits_equal(outs[0], (rays.origin, rays.dir, rays.weight,
                               stats.vignetted)),
          "entry: fn differs from create_rays on the same inputs")
    check(only(launched, raytraced=3),
          f"entry: launches {launched}, not one raytraced launch a call")

    n_cards = torch.cuda.device_count()
    n_sub = min(n_cards, entry.KERNEL_PASS_MAX_DEVICES)
    reset_counts(trace_kernel, bokeh_kernel, rk)
    dry, dry_s = seconds(lambda: entry.dryrun_multichip(n_cards))
    dry_launched = counts(trace_kernel, bokeh_kernel, rk)
    for label, st, rays_n in (
            ("jnp", dry.eager, entry.RAYS_PER_DEVICE * n_cards),
            ("kernel", dry.kernel, entry.RAYS_PER_DEVICE * n_sub)):
        check(int(st.success) + int(st.vignetted) == rays_n,
              f"dryrun {label}: success + vignetted != {rays_n}")
    check(only(dry_launched, raytraced=n_sub),
          f"dryrun: launches {dry_launched}, not one raytraced launch a "
          f"card of the kernel pass")
    add_counts(launched, dry_launched)

    cases = [("entry", state, entry.config(), (sx, sy, lx, ly), seed)]
    cfg = entry.config(entry.DRYRUN_LUT_SAMPLES).replace(**entry.KERNEL_PASS)
    mesh = entry.mesh(n_sub)
    shards = sharding.shard_samples(mesh, *entry.samples(
        entry.RAYS_PER_DEVICE * n_sub, entry.KERNEL_SAMPLE_SEED, dev))
    for k, st in enumerate(mesh.replicas(dry.state)):
        cases.append((f"dryrun kernel pass shard {k}", st, cfg,
                      [a[k] for a in shards],
                      sharding.shard_seed(entry.DRYRUN_SEED, k)))
    errs = []
    for label, st, c, (a, b, u, v), s in cases:
        u1, u2, kw = rt_model.kernel_inputs(st, c, u, v, s)
        with torch.cuda.device(a.device):
            cmp = kernel_vs_plain(
                trace_kernel, label,
                (st.lens, a, b, u1, u2, st.sensor_width, s), kw, c.max_tries,
                f"{tag} entry {label} ({a.numel()} rays, max_tries "
                f"{c.max_tries}) kernel vs plain",
                math.ceil(a.numel() * MAX_TRIES_MISMATCH / BATCH))
        errs.append(cmp["max_abs_err"])
    phase_s = time.perf_counter() - t0
    print(f"[{tag} entry] entry(): compile {compile_s:.2f} s; fn on {n} "
          f"samples twice: shapes {shapes}, finite, bit-equal between the "
          f"calls and to create_rays on the same state, samples and seed "
          f"(vignetted {int(stats.vignetted)}); dryrun_multichip("
          f"{n_cards}) {dry_s:.2f} s: jnp success {int(dry.eager.success)} "
          f"vignetted {int(dry.eager.vignetted)}, kernel success "
          f"{int(dry.kernel.success)} vignetted {int(dry.kernel.vignetted)}; "
          f"launches {launched}; phase {phase_s:.2f} s on {smi}", flush=True)
    return {"launches": launched, "compile_s": compile_s, "dryrun_s": dry_s,
            "seconds": phase_s, "max_abs_err": max(errs)}


def main(argv=None) -> None:
    global PRIMER_CYCLES
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--primer-cycles", type=int, default=PRIMER_CYCLES,
                    help="clocks of the kernel that opens each profiler "
                         "window; 0 opens them with the calls")
    PRIMER_CYCLES = ap.parse_args(argv).primer_cycles
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke FAILED: torch.cuda.is_available() is "
                         "False; this smoke test needs a CUDA card")
    import zoic_tpu_torch as zt
    from zoic_tpu_torch.ops import _build, bokeh_kernel, circles_kernel
    from zoic_tpu_torch.ops import trace_kernel
    from zoic_tpu_torch.ops import roofline_kernel
    from zoic_tpu_torch.tools import roofline
    from zoic_tpu_torch.utils import profiling

    t_script = time.perf_counter()
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    print(f"[1 device] {kind} | nvidia-smi: {smi} | torch {torch.__version__}"
          f" cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    _build.load_all(BUILDS)
    print(f"[2 build] csrc/{{{','.join(KERNELS)}}}.cu for sm_90a, raytraced "
          f"and thinlens also counting lanes, in "
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
    print("[11s thin-lens summary] " + json.dumps({
        name: {k: r[k] for k in ("kernel_ms", "device_ms", "plain_ms",
                                 "create_rays_ms", "split")}
        for name, r in thin.items()}), flush=True)
    # ---- the bokeh kernel against its plain version on both paths, and
    # its retry-plane entry
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    sizes = (*RAGGED_SIZES, sms * 32 * trace_kernel.WARPS_PER_BLOCK - 29)
    bk_rows = bokeh_phase(zt, bokeh_kernel, bokeh_path, dev, smi, "12")
    bk = bk_rows[BOKEH_IMAGES[0][0]]
    bokeh_state = zt.load_state(zt.data.state_path("raytraced_bokeh_image"),
                                device=dev)
    bpl = planes_phase(zt, bokeh_kernel, bokeh_state, sizes, dev, smi, "12")

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
                                 "vignetted_frac", "mismatches", "split")}
        for name, r in rt.items()}), flush=True)

    # ---- what must not depend on the schedule: ragged batches, lane use
    ragged_err = max(
        ragged_phase(zt, trace_kernel, "raytraced_headline", state,
                     raytraced_config(zt, "headline"), sizes, dev, "23a"),
        ragged_phase(zt, trace_kernel, "raytraced_bokeh_image", bokeh_state,
                     raytraced_config(zt, "raytraced_bokeh_image",
                                      bokeh_path), sizes, dev, "23b"))
    lanes = lane_use_phase(dev, smi, "23c")

    # ---- the lens compile, the microbenchmark, the bench
    comp = compile_phase(zt, trace_kernel, bokeh_kernel, bokeh_path, dev, smi,
                         "24")
    circ = circles_phase(zt, dev, smi, "24b")
    roof = roofline_phase(roofline_kernel, roofline, profiling, dev, smi,
                          "25")
    bn = bench_phase(trace_kernel, bokeh_kernel, roofline_kernel, kind, "26")

    # ---- the library surface: Camera and render, update, state files and
    # the compile cache, the eager path, data parallelism
    kernels = (trace_kernel, bokeh_kernel, roofline_kernel)
    t_surface = time.perf_counter()
    surface = {"camera": camera_phase(zt, kernels, bokeh_path, dev, smi, "27")}
    cam, cam_cfg = surface["camera"]["cam"], surface["camera"]["cfg"]
    surface["update"] = update_phase(zt, kernels, cam, cam_cfg,
                                     surface["camera"]["bokeh_cam"], dev, smi,
                                     "28")
    surface["state_io"] = state_io_phase(zt, kernels, cam, cam_cfg, dev, smi,
                                         "29")
    surface["eager"] = eager_phase(zt, kernels, state, dev, smi, "30")
    surface["sharding"] = sharding_phase(zt, kernels, state, kind, dev, smi,
                                         "31")
    more = {}
    for r in surface.values():
        add_counts(more, r["launches"])
    surface_s = time.perf_counter() - t_surface

    # ---- the diagnostics: draw mode, the tape, dumps, pupil plots
    t_diag = time.perf_counter()
    diag = diag_phase(zt, kernels, bokeh_path, dev, smi, "33")
    surface_launches = dict(more)
    add_counts(more, diag["launches"])
    diag_s = time.perf_counter() - t_diag

    # ---- the examples: the render demo on every lens, the optimisation
    t_examples = time.perf_counter()
    examples = examples_phase(zt, kernels, dev, smi, "34")
    add_counts(more, examples["launches"])
    examples_s = time.perf_counter() - t_examples

    # ---- the entry points of __graft_entry__.py's counterpart
    entry_run = entry_phase(zt, kernels, dev, smi, "35")
    add_counts(more, entry_run["launches"])

    from zoic_tpu_torch.bench import USEFUL_OPS_PER_RAY

    rep = thin["thinlens_f1.4"]
    epi = head["epilogue"]
    rt_bound = bound(head["bytes"], USEFUL_OPS_PER_RAY * BATCH)
    thin_bound, bokeh_bound, planes_bound = (
        rep["bound"], bk["bound"], bpl["bound"])
    entries = [{
        "name": "raytraced",
        "route": "cuda",
        "source": "zoic_tpu_torch/csrc/raytraced.cu",
        "replaces": "zoic_tpu/ops/trace_kernel.py:975",
        "launches": (sum(r["launches"] for r in rt.values())
                     + more["raytraced"]),
        "max_abs_err": max([r["max_abs_err"] for r in rt.values()]
                           + [r["max_abs_err"]
                              for r in examples["lenses"].values()
                              if "max_abs_err" in r]
                           + [entry_run["max_abs_err"]]),
        "ms": head["kernel_ms"],
        "device_ms": head["device_ms"],
        "finished_ms": head["finished_ms"],
        "finished_device_ms": head["finished_device_ms"],
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
        "replaces": "zoic_tpu/ops/trace_kernel.py:1381 and the thin lens's "
                    "XLA-fused epilogue, zoic_tpu/models/common.py:105",
        "launches": (sum(r["launches"] for r in thin.values())
                     + more["thinlens"]),
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
                     + sum(r["bokeh_launches"] for r in rt.values())
                     + more["bokeh"]),
        "max_abs_err": bk["max_abs_err"],
        "ms": bk["kernel_ms"],
        "device_ms": bk["device_ms"],
        "plain_ms": bk["plain_ms"],
        "bound_ms": bokeh_bound[0],
        "bound_by": bokeh_bound[1],
        "library_ms": None,
        "config": "64x64 disk",
    }, {
        "name": "bokeh_planes",
        "route": "cuda",
        "source": "zoic_tpu_torch/csrc/bokeh.cu",
        "replaces": "zoic_tpu/models/raytraced.py:225",
        "launches": (sum(r["plane_launches"] for r in rt.values())
                     + more["bokeh_planes"]),
        "max_abs_err": bpl["max_abs_err"],
        "ms": bpl["kernel_ms"],
        "device_ms": bpl["device_ms"],
        "plain_ms": bpl["plain_ms"],
        "bound_ms": planes_bound[0],
        "bound_by": planes_bound[1],
        "library_ms": None,
        "config": f"raytraced_bokeh_image, {bpl['cells']} cells",
    }, {
        "name": "roofline",
        "route": "cuda",
        "source": "zoic_tpu_torch/csrc/roofline.cu",
        "replaces": "tools/roofline.py:83",
        "launches": bn["launches"] + more["roofline"],
        "max_abs_err": roof["max_abs_err"],
        "ms": roof["ms"],
        "device_ms": roof["device_ms"],
        "plain_ms": roof["plain_ms"],
        "bound_ms": roof["bound_ms"],
        "bound_by": roof["bound_by"],
        "library_ms": None,
        "config": "fma",
    }, {
        "name": "epilogue",
        "route": "cuda",
        "source": "zoic_tpu_torch/csrc/epilogue.cu",
        "replaces": "zoic_tpu/models/common.py:105",
        "launches": (sum(r["epilogue_launches"] for r in rt.values())
                     + more["epilogue"]),
        "max_abs_err": max([r["epilogue"]["max_abs_err"]
                            for r in rt.values()] + [ragged_err]),
        "ms": epi["kernel_ms"],
        "device_ms": epi["device_ms"],
        "plain_ms": epi["plain_ms"],
        "bound_ms": epi["bound"][0],
        "bound_by": epi["bound"][1],
        "library_ms": None,
        "config": "raytraced_headline",
    }, {
        "name": "circles",
        "route": "cuda",
        "source": "zoic_tpu_torch/csrc/circles.cu",
        "replaces": "no TPU kernel: the JAX package fits on the host in "
                    "numpy, zoic_tpu/pupil.py:612",
        "launches": circles_kernel.launches,
        "max_abs_err": circ["max_abs_err"],
        "ms": circ["ms"],
        "device_ms": circ["device_ms"],
        "plain_ms": circ["plain_ms"],
        "bound_ms": circ["bound_ms"],
        "bound_by": circ["bound_by"],
        "library_ms": None,
        "config": f"headline fit cover, 32 keys x {CIRCLES_N}",
        "entries_ms": circ["entries_ms"],
        "card_us": circ["card_us"],
    }]
    check(rt["raytraced_bokeh_image"]["bokeh_launches"] > 0
          and entries[2]["launches"] > 0 and entries[3]["launches"] > 0,
          "the bokeh configs launched no bokeh kernel or plane entry")
    check(entries[5]["launches"] > 0,
          "the epilogue's own checks did not launch it")
    check(entries[1]["launches"] > 0,
          "the thin-lens main paths did not run the thin-lens kernel")

    print("[32 summary] " + json.dumps({
        "compile_s": {n: r["compile_s"] for n, r in comp.items()},
        "mc_statics_equal": {n: r["mc_statics_equal"]
                             for n, r in comp.items()},
        "roofline_top_s": {n: r["rate"] / 1e12
                           for n, r in roof["rows"].items()},
        "roofline_bound_share": {n: r["bound_ms"] / r["ms"]
                                 for n, r in roof["rows"].items()},
        "roofline_ieee_sweep": {n: [r["operands"], r["mismatches"]]
                                for n, r in roof["sweep"].items()},
        "roofline_clocks_mhz": roof["clocks_mhz"],
        "bokeh_images": bk_rows,
        "lanes_per_warp_trace": {n: r["lanes_per_warp_trace"]
                                 for n, r in lanes.items()
                                 if "lanes_per_warp_trace" in r},
        "seconds": {"script": time.perf_counter() - t_script,
                    "phases_27_31": surface_s, "phase_33": diag_s,
                    "phase_34": examples_s, "phase_35": entry_run["seconds"]},
        "profile_readings": READINGS,
        "surface": {
            "launches": surface_launches,
            "camera_compile_s": surface["camera"]["compile_s"],
            "render_ms": surface["camera"]["render_ms"],
            "frame_samples_ms": surface["camera"]["frame_samples_ms"],
            "recompile_s": surface["update"]["recompile_s"],
            "cached_compile_s": [surface["state_io"]["compile_s"],
                                 surface["state_io"]["load_s"]],
            "eager_vs_kernel_ms": {
                b: [r["eager_ms"], r["kernel_ms"]]
                for b, r in surface["eager"]["rows"].items()},
            "grad_rel": surface["eager"]["grad_rel"],
            "mesh_rays_per_sec": surface["sharding"]["mesh_rays_per_sec"],
        },
        "diag": {"launches": diag["launches"], "cameras": diag["cameras"],
                 "coverage": diag["coverage"],
                 "selftest_s": diag["selftest_s"],
                 "matplotlib": diag["matplotlib"]},
        "examples": {"launches": examples["launches"],
                     "lenses": examples["lenses"],
                     "optimisation": examples["optimisation"]},
    }), flush=True)
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    sys.exit(main())
