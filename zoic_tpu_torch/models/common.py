"""Epilogue shared by the camera models: weights, exposure, the fake
derivatives and the run counters (``zoic_tpu/models/common.py:105-136``).

The reference's boundary quirk is kept: a ray leaves the retry loop with
``tries == max_tries + 1`` whether or not its last retry succeeded, and
``tries > max_tries`` zero-weights it, so a ray whose 26th retry succeeds
is still vignetted (zoic.cpp:1824-1827, 1951-1954).
"""

from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor


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
