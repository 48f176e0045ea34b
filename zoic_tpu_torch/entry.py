"""Entry points: one card's forward step and a multi-device dry run.

Counterpart of ``__graft_entry__.py``.  :func:`entry` returns the headline
camera's forward step and its example inputs; :func:`dryrun_multichip`
runs the sharded step over a mesh of ``n`` devices, first on the exact
eager path and then through the raytraced kernel.  Both run on the CUDA
cards unless the caller asks for the CPU, and neither falls back to the
CPU when a card is missing::

    python -m zoic_tpu_torch.entry                          # every card
    python -m zoic_tpu_torch.entry --device cpu --devices 8

The JAX side re-executes its dry run in a clean subprocess to hide a TPU
plugin from the virtual CPU mesh; nothing here needs that.
"""

from __future__ import annotations

import argparse
from typing import Callable, NamedTuple, Tuple

import torch

from . import data
from .camera import compile_camera, create_rays
from .config import CameraConfig, LensModel
from .parallel import sharding
from .system import CameraState, RayStats

Tensor = torch.Tensor

# the headline camera (BASELINE.json's north star), as __graft_entry__.py
# configures it; the entry compiles its LUT from 10,000 samples, the dry run
# from 2,000
LENS = "double_gauss_f2.0"
CAMERA = dict(focal_length=5.0, fstop=2.0, focal_distance=100.0)
ENTRY_LUT_SAMPLES = 10_000
DRYRUN_LUT_SAMPLES = 2_000
ENTRY_RAYS = 65_536
RAYS_PER_DEVICE = 128
# the seeds where __graft_entry__.py passes PRNGKey(k): the samples of the
# entry and of the dry run's first pass, the entry's retries, the dry run's
# retries, the samples of its kernel pass
SAMPLE_SEED = 0
ENTRY_SEED = 1
DRYRUN_SEED = 7
KERNEL_SAMPLE_SEED = 3
# the dry run's second pass: the kernel path with a small retry budget on at
# most four devices.  The JAX package caps it because interpret-mode kernels
# on more than four concurrent shards deadlock its CPU client; the cap stays
# here so that both dry runs do the same work.
KERNEL_PASS = dict(impl="pallas", max_tries=4)
KERNEL_PASS_MAX_DEVICES = 4


class DryRun(NamedTuple):
    """What :func:`dryrun_multichip` ran: the state compiled once for both
    passes, and each pass's summed run counters."""

    state: CameraState
    eager: RayStats
    kernel: RayStats


def config(lut_bounds_samples: int = ENTRY_LUT_SAMPLES) -> CameraConfig:
    """The headline camera: RAYTRACED Double Gauss f/2.0, focal length
    5 cm, f/2, focus 100 cm, exit-pupil LUT and pupil pre-check on."""
    return CameraConfig(
        lens_model=LensModel.RAYTRACED,
        lens_data_path=data.lens_path(LENS),
        lut_bounds_samples=lut_bounds_samples,
        **CAMERA,
    )


def samples(n: int, seed: int, device) -> Tuple[Tensor, ...]:
    """``(sx, sy, lensx, lensy)``: ``n`` draws each from a
    ``torch.Generator`` on ``device`` seeded ``seed``, screen samples in
    [-1, 1] and lens samples in [0, 1]."""
    g = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand((4, n), generator=g, device=device)
    return u[0] * 2.0 - 1.0, u[1] * 2.0 - 1.0, u[2], u[3]


def entry(device="cuda") -> Tuple[Callable, tuple]:
    """``(fn, example_args)``: the forward step of the headline camera,
    compiled by :func:`compile_camera` on ``device``.

    ``fn(state, sx, sy, lensx, lensy, seed)`` returns ``(origin, dir,
    weight, vignetted)`` of :func:`create_rays`; flat samples on a card run
    ``csrc/raytraced.cu``.  ``example_args`` holds the state, 65,536
    samples from a ``torch.Generator`` seeded 0 and the retry seed 1 where
    the JAX package passes ``PRNGKey(1)``; the draws are not JAX's
    values."""
    cfg = config(ENTRY_LUT_SAMPLES)
    state = compile_camera(cfg, device)

    def fn(state, sx, sy, lensx, lensy, seed):
        rays, stats = create_rays(state, cfg, sx, sy, lensx, lensy, seed=seed)
        return rays.origin, rays.dir, rays.weight, stats.vignetted

    return fn, (state, *samples(ENTRY_RAYS, SAMPLE_SEED, device), ENTRY_SEED)


def mesh(n_devices: int, device="cuda") -> sharding.Mesh:
    """A mesh of ``n_devices`` devices of the kind asked for: ``["cpu"] *
    n``, or the first ``n`` visible cards (fewer raise)."""
    kind = torch.device(device).type
    if kind == "cpu":
        return sharding.make_mesh(["cpu"] * n_devices)
    if kind != "cuda":
        raise ValueError(f"unsupported device {device!r}: 'cuda' or 'cpu'")
    return sharding.make_mesh(count=n_devices)


def _sharded_pass(label, m, state, cfg, sample_seed) -> RayStats:
    """One pass of the dry run over the mesh ``m``: ``RAYS_PER_DEVICE`` rays
    a device through :func:`sharding.create_rays_sharded`, its asserts and
    its line."""
    n = RAYS_PER_DEVICE * m.size
    shards = sharding.shard_samples(
        m, *samples(n, sample_seed, m.devices[0]))
    rays, stats = sharding.create_rays_sharded(m, state, cfg, *shards,
                                               seed=DRYRUN_SEED)
    success, vignetted = int(stats.success), int(stats.vignetted)
    assert rays.origin.shape == (n, 3), tuple(rays.origin.shape)
    assert success + vignetted == n, (success, vignetted, n)
    print(f"dryrun_multichip {label} OK: {m.size} devices, {n} rays, "
          f"success={success} vignetted={vignetted}", flush=True)
    return stats


def dryrun_multichip(n_devices: int, device="cuda") -> DryRun:
    """Run the sharded render step over a mesh of ``n_devices`` devices on
    small shapes.

    The multi-device strategy is data parallelism over rays (rays never
    communicate; the run counters are summed), the batch split over a 1-D
    mesh and the lens state copied to each device.  One state, compiled on
    the first device, serves both passes: the exact eager path
    (``impl="jnp"``) at 128 rays a device, then the kernel path
    (:data:`KERNEL_PASS`) on the first ``min(n_devices, 4)`` devices, which
    launches ``csrc/raytraced.cu`` on the cards and runs its plain version
    on the CPU.  Asking for more cards than are visible raises."""
    full = mesh(n_devices, device)
    cfg = config(DRYRUN_LUT_SAMPLES)
    state = compile_camera(cfg, full.devices[0])
    eager = _sharded_pass("jnp", full, state, cfg.replace(impl="jnp"),
                          SAMPLE_SEED)
    sub_mesh = sharding.make_mesh(
        full.devices[:min(n_devices, KERNEL_PASS_MAX_DEVICES)])
    kernel = _sharded_pass("kernel", sub_mesh, state,
                           cfg.replace(**KERNEL_PASS), KERNEL_SAMPLE_SEED)
    return DryRun(state, eager, kernel)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--devices", type=int, default=None,
                    help="mesh size of the dry run (default: every visible "
                         "card; required with --device cpu)")
    args = ap.parse_args(argv)
    n = args.devices
    if n is None:
        if args.device == "cpu":
            ap.error("--device cpu needs --devices N")
        n = torch.cuda.device_count()
    fn, example_args = entry(args.device)
    out = fn(*example_args)
    print("entry OK:", [tuple(o.shape) for o in out], flush=True)
    dryrun_multichip(n, args.device)


if __name__ == "__main__":
    main()
