"""What the camera models share (``zoic_tpu/models/common.py``): the
eager path's aperture sampler and retry rounds, and the epilogue of both
paths (weights, exposure, the fake derivatives and the run counters).

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
from ..system import RayBatch

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


def weight_and_stats(
    tries: Tensor, max_tries: int
) -> Tuple[Tensor, Tensor, Tensor]:
    """Returns ``(weight f32[B], success i32[], vignetted i32[])``."""
    vignetted = tries > max_tries
    weight = torch.where(vignetted, 0.0, 1.0).to(torch.float32)
    n_vig = vignetted.sum(dtype=torch.int32)
    n_ok = (~vignetted).sum(dtype=torch.int32)
    return weight, n_ok, n_vig


def apply_exposure(weight: Tensor, exposure_control: Tensor) -> Tensor:
    """x(1+e^2) for e > 0, x 1/(1+e^2) for e < 0 (zoic.cpp:1980-1987)."""
    e2 = exposure_control * exposure_control
    up = weight * (1.0 + e2)
    down = weight * (1.0 / (1.0 + e2))
    return torch.where(
        exposure_control > 0.0, up,
        torch.where(exposure_control < 0.0, down, weight),
    )


def fake_derivatives(
    tries: Tensor, origin: Tensor, direction: Tensor
) -> Tuple[Tensor, Tensor]:
    """dOdy = origin and dDdy = dir where the ray was retried, else zero
    (zoic.cpp:1974-1977)."""
    retried = (tries > 0)[..., None]
    zeros = torch.zeros_like(origin)
    return (torch.where(retried, origin, zeros),
            torch.where(retried, direction, zeros))
