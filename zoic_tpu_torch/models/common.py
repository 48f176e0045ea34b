"""What the camera models share (``zoic_tpu/models/common.py``): the
eager path's aperture sampler and retry rounds, and the epilogue of both
paths (weights, exposure, the fake derivatives and the run counters),
whose pieces live in :mod:`..ops.epilogue_kernel`: both camera kernels
compute it where their rays finish
(:func:`~..ops.trace_kernel.raytraced_rays`,
:func:`~..ops.trace_kernel.thinlens_rays`), and the eager path composes
:func:`weight_and_stats`, :func:`apply_exposure` and
:func:`fake_derivatives` itself.

The reference's per-ray ``while (!ok && tries <= maxtries)`` resample loops
(src/zoic.cpp:1802-1830 thin lens, 1879-1957 raytraced) become whole-batch
masked rounds (:func:`resample_rounds`): round r gives every still-pending
ray its r-th retry from fresh uniforms, so each ray's accepted sample has
the sequential loop's distribution.  The reference's boundary quirk is
kept: a ray leaves the loop with ``tries == max_tries + 1`` whether or not
its last retry succeeded, and ``tries > max_tries`` zero-weights it, so a
ray whose 26th retry succeeds is still vignetted (zoic.cpp:1824-1827,
1951-1954).

The retry uniforms come from a ``torch.Generator`` where the JAX package
folds a ``jax.random`` key per round, so the eager path matches the JAX
package's by distribution, not bit for bit; its first attempt is
deterministic.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from .. import bokeh as bokeh_mod
from .. import sampling
from ..ops.epilogue_kernel import (  # noqa: F401
    apply_exposure, fake_derivatives, weight_and_stats)
from ..system import RayBatch, RayStats

Tensor = torch.Tensor


def retry_generator(seed: Optional[int], generator: Optional[torch.Generator],
                    device) -> torch.Generator:
    """The eager path's source of retry uniforms: ``generator``, or a
    generator on ``device`` seeded with ``seed`` when only the seed is
    given."""
    if generator is not None:
        return generator
    if seed is None:
        raise ValueError("create_rays needs a seed or a torch.Generator")
    return torch.Generator(device=device).manual_seed(seed)


def unflatten(rays: RayBatch, shape: torch.Size) -> RayBatch:
    """The fields of a flat ``[B]`` batch in the caller's batch ``shape``:
    the kernels take flat samples, the models any batch shape."""
    return RayBatch(*(f.reshape(shape + f.shape[1:]) for f in (
        rays.origin, rays.dir, rays.weight, rays.d_ody, rays.d_ddy)))


def aperture_sample(use_image: bool, bokeh_image, u1: Tensor,
                    u2: Tensor) -> Tuple[Tensor, Tensor]:
    """Sampler dispatch (zoic.cpp:1787, 1870): the concentric disk map, or
    image-based bokeh CDF inversion, for uniforms of any batch shape."""
    if not use_image:
        return sampling.concentric_disk_sample(u1, u2)
    if bokeh_image is None:
        raise ValueError("use_image=True needs a state with a bokeh image")
    dx, dy = bokeh_mod.sample(bokeh_image, u1.reshape(-1), u2.reshape(-1))
    return dx.reshape(u1.shape), dy.reshape(u1.shape)


def resample_rounds(
    initial_ok: Tensor,
    initial_payload: tuple,
    retry_fn: Callable[[Tensor, Tensor], Tuple[Tensor, tuple, Tensor]],
    generator: torch.Generator,
    max_tries: int,
    initial_tir: Tensor,
) -> Tuple[Tensor, tuple, Tensor, Tensor]:
    """Run masked retry rounds until every ray succeeded or the budget is
    spent.

    Round r (1-based, at most ``max_tries + 1`` of them) draws
    ``torch.rand((2,) + B)`` from ``generator`` for the whole batch, so the
    stream does not depend on which rays are pending, and calls
    ``retry_fn(u, pending) -> (ok, payload, tir_count)`` on it; the results
    are merged for the pending rays only.  Deciding whether a round is
    needed reads one flag from the device.  Returns ``(ok, payload, tries,
    tir_total)``."""
    dev = initial_ok.device
    b = tuple(initial_ok.shape)
    ok, payload, tir_total = initial_ok, tuple(initial_payload), initial_tir
    tries = torch.zeros(b, dtype=torch.int32, device=dev)
    rnd = 1
    while rnd <= max_tries + 1 and bool((~ok).any()):
        u = torch.rand((2,) + b, generator=generator, dtype=torch.float32,
                       device=dev)
        pending = ~ok
        new_ok, new_payload, tir = retry_fn(u, pending)
        ok = torch.where(pending, new_ok, ok)
        payload = tuple(torch.where(pending, new, old)
                        for new, old in zip(new_payload, payload))
        tries = torch.where(pending, rnd, tries)
        tir_total = tir_total + tir
        rnd += 1
    return ok, payload, tries, tir_total


def ray_stats(stats: Tensor) -> RayStats:
    """The run counters of an epilogue's ``stats`` i32[4] buffer (success,
    vignetted, tir, tries_total), each a 0-d view of it."""
    return RayStats(*stats.unbind())
