"""Data-parallel ray generation over a list of devices.

Port of ``zoic_tpu/parallel/sharding.py``.  The reference's only
parallelism is the renderer's thread pool calling ``camera_create_ray``
against shared read-only state: rays never communicate.  Here the batch is
split into equal contiguous shards, one per device of a :class:`Mesh`; the
compiled state is copied to each device once; each shard runs
:func:`zoic_tpu_torch.create_rays` on its device, the launches of every
device queued before anything is read back, so cards work at once; the run
counters are summed.  The JAX package folds its key per shard, so its
sharded retries differ from its unsharded ones; here shard ``k`` takes the
seed ``(seed + k * 0x9E3779B1) % 2**22``, decorrelated across shards, and
shard 0 keeps the seed, so a mesh of one device equals the plain call bit
for bit.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from ..camera import create_rays
from ..config import CameraConfig
from ..system import CameraState, RayBatch, RayStats

Tensor = torch.Tensor

SHARD_SEED_STRIDE = 0x9E3779B1
SEED_RANGE = 1 << 22


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """A 1-D list of devices to split the batch over (a device may repeat:
    its shards then run one after the other).  Keeps the copies of the
    last state it was handed, one per device."""

    def __init__(self, devices: Sequence):
        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.devices = tuple(_device(d) for d in devices)
        self._state: Optional[CameraState] = None
        self._copies: dict = {}

    @property
    def size(self) -> int:
        return len(self.devices)

    def replicas(self, state: CameraState) -> List[CameraState]:
        """``state`` on each device of the mesh, copied once per device."""
        if state is not self._state:
            self._state, self._copies = state, {state.device: state}
        for d in self.devices:
            if d not in self._copies:
                self._copies[d] = state.to(d)
        return [self._copies[d] for d in self.devices]


def make_mesh(devices: Optional[Sequence] = None,
              count: Optional[int] = None) -> Mesh:
    """A mesh over ``devices``, or over the first ``count`` visible CUDA
    cards (every one by default) as ``torch.device("cuda:i")``; fewer
    visible cards than ``count`` raise."""
    if devices is None:
        have = torch.cuda.device_count()
        if count is not None and have < count:
            raise RuntimeError(f"make_mesh: {count} CUDA cards asked for, "
                               f"{have} visible")
        devices = [torch.device("cuda", i) for i in range(
            have if count is None else count)]
        if not devices:
            raise RuntimeError("make_mesh: no CUDA card is visible; pass "
                               "the devices, e.g. ['cpu'] * 4")
    return Mesh(devices)


def shard_seed(seed: int, k: int) -> int:
    """The retry seed of shard ``k``."""
    return (seed + k * SHARD_SEED_STRIDE) % SEED_RANGE


def shard_samples(mesh: Mesh, *arrays) -> Tuple[List[Tensor], ...]:
    """Split each flat array into the mesh's shards, shard ``k`` on device
    ``k``: laying samples out once saves the copies a call would make.  An
    array already given as a list of shards is checked and moved."""
    out = []
    for a in arrays:
        if isinstance(a, (list, tuple)):
            if len(a) != mesh.size:
                raise ValueError(f"{len(a)} shards for a mesh of {mesh.size}")
            out.append([t.to(d) for t, d in zip(a, mesh.devices)])
            continue
        b = a.shape[0]
        if b % mesh.size:
            raise ValueError(
                f"batch size {b} not divisible by mesh size {mesh.size}")
        per = b // mesh.size
        out.append([a[k * per:(k + 1) * per].to(d, non_blocking=True)
                    for k, d in enumerate(mesh.devices)])
    return tuple(out)


def create_rays_shards(
    mesh: Mesh,
    state: CameraState,
    config: CameraConfig,
    sx, sy, lensx, lensy,
    *,
    seed: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
) -> List[Tuple[RayBatch, RayStats]]:
    """:func:`create_rays` on each shard, on its device: the per-shard
    results, unread.  Samples are flat tensors (split here) or lists of
    shards (:func:`shard_samples`); the batch must divide by the mesh
    size.  The retry seed is ``seed``, or one drawn from ``generator``."""
    shards = shard_samples(mesh, sx, sy, lensx, lensy)
    if seed is None:
        if generator is None:
            raise ValueError("create_rays_sharded needs a seed or a "
                             "torch.Generator")
        # the JAX package draws it as jax.random.randint(key, (), 0, 1 << 22)
        seed = int(torch.randint(0, SEED_RANGE, (), generator=generator,
                                 device=generator.device))
    return [create_rays(st, config, *(s[k] for s in shards),
                        seed=shard_seed(seed, k))
            for k, st in enumerate(mesh.replicas(state))]


def create_rays_sharded(
    mesh: Mesh,
    state: CameraState,
    config: CameraConfig,
    sx, sy, lensx, lensy,
    *,
    seed: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[RayBatch, RayStats]:
    """Generate rays with the batch split across the mesh
    (:func:`create_rays_shards`).  The rays are gathered in batch order on
    the mesh's first device; the stats are summed there as int32."""
    outs = create_rays_shards(mesh, state, config, sx, sy, lensx, lensy,
                              seed=seed, generator=generator)
    dev0 = mesh.devices[0]

    def gather(ts):
        return ts[0] if len(ts) == 1 else torch.cat([t.to(dev0) for t in ts])

    rays = RayBatch(*(gather([getattr(r, f.name) for r, _ in outs])
                      for f in dataclasses.fields(RayBatch)))
    stats = RayStats(*(
        torch.stack([getattr(s, f.name).to(dev0) for _, s in outs]).sum(
            dtype=torch.int32)
        for f in dataclasses.fields(RayStats)))
    return rays, stats
