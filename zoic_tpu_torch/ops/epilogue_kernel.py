"""The epilogue of the raytraced model's kernel path: the CUDA kernel's
wrapper and its plain PyTorch version.  The thin lens's kernel path
computes the same in its camera kernel
(:func:`..ops.trace_kernel.thinlens_rays`); :func:`epilogue_plain` is its
plain version's second half.

The JAX package computes it with jnp ops that XLA fuses into the jitted
``create_rays`` after the Pallas call (``zoic_tpu/models/common.py:
weight_and_stats, apply_exposure, fake_derivatives``, and the counter sums
of ``zoic_tpu/models/raytraced.py`` and ``zoic_tpu/models/thinlens.py``).
Per ray, from the camera kernel's ``tries``, ``tir``, origin and
direction:

* ``weight`` is 0 iff ``tries > max_tries``, else 1; a ray whose last
  retry succeeded still leaves the loop with ``tries == max_tries + 1``
  and is zero-weighted (zoic.cpp:1824-1827, 1951-1954);
* the exposure scales it by ``1 + e^2`` for ``e > 0`` and by ``1 / (1 +
  e^2)`` for ``e < 0`` (zoic.cpp:1980-1987);
* ``dOdy`` and ``dDdy`` are origin and direction where the ray was
  retried, else 0 (zoic.cpp:1974-1977);
* the counters: successes, vignetted rays, the TIR sum and the tries sum,
  int32.

:func:`epilogue_fused` launches ``csrc/epilogue.cu`` for CUDA tensors (the
counter buffer zeroed and the one pass: two device operations, no read
back) and runs :func:`epilogue_plain`, the composition of
:func:`weight_and_stats`, :func:`apply_exposure` and
:func:`fake_derivatives`, for CPU tensors.  The eager path of the models
runs that composition itself.  :func:`epilogue_plain` also takes the thin
lens's two modes, which its kernel computes in its own final store: the
pinhole (``count_weight=False``) keeps weight 1 before the exposure and
counts neither successes nor vignetted rays, and without ``tir`` the TIR
counter is 0.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..utils.profiling import span
from . import _launch

Tensor = torch.Tensor

# launches of the CUDA kernel by epilogue_fused (plain CPU runs not counted)
launches = 0


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


def epilogue_plain(
    tries: Tensor, tir: Optional[Tensor], origin: Tensor, direction: Tensor,
    exposure: Tensor, max_tries: int, *, count_weight: bool = True,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Plain PyTorch version on any device: ``(weight f32[B], d_ody
    f32[B,3], d_ddy f32[B,3], stats i32[4])``, ``stats`` holding success,
    vignetted, tir and tries_total."""
    zero = torch.zeros((), dtype=torch.int32, device=tries.device)
    if count_weight:
        weight, n_ok, n_vig = weight_and_stats(tries, max_tries)
    else:
        weight = torch.ones(tries.shape, dtype=torch.float32,
                            device=tries.device)
        n_ok = n_vig = zero
    d_ody, d_ddy = fake_derivatives(tries, origin, direction)
    weight = apply_exposure(weight, exposure)
    n_tir = zero if tir is None else tir.sum(dtype=torch.int32)
    stats = torch.stack([n_ok, n_vig, n_tir, tries.sum(dtype=torch.int32)])
    return weight, d_ody, d_ddy, stats


_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 2 + [ctypes.c_void_p]


def _check(tries, tir, origin, direction, exposure):
    """Hold the kernel's inputs to one device, their types, shapes and
    contiguity; returns ``(B, device, exposure)``, the exposure as a 0-d
    float32 tensor on the device (the state's own tensor when it is one)."""
    b, dev = _launch.check_flat((("tries", tries), ("tir", tir)), torch.int32)
    for name, t in (("origin", origin), ("direction", direction)):
        if t.device != dev or t.dtype != torch.float32 or t.shape != (b, 3):
            raise ValueError(
                f"{name} must be float32 of shape ({b}, 3) on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous, got stride "
                             f"{t.stride()}")
    return b, dev, exposure_on(exposure, dev)


def exposure_on(exposure, dev: torch.device) -> Tensor:
    """The exposure as a 0-d float32 tensor on ``dev``, the state's own
    tensor when it is one; raises when it is not 0-d."""
    exposure = torch.as_tensor(exposure, dtype=torch.float32, device=dev)
    if exposure.dim() != 0:
        raise ValueError(f"exposure must be 0-d, got {tuple(exposure.shape)}")
    return exposure


def epilogue_fused(
    tries: Tensor, tir: Tensor, origin: Tensor, direction: Tensor,
    exposure: Tensor, max_tries: int,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """The epilogue over the raytraced kernel's flat outputs: ``tries`` and
    ``tir`` i32[B], ``origin`` and ``direction`` f32[B,3], the
    state's 0-d ``exposure``.  Returns ``(weight f32[B], d_ody f32[B,3],
    d_ddy f32[B,3], stats i32[4])``, ``stats`` holding success, vignetted,
    tir and tries_total (``RayStats`` takes 0-d views of it).  CUDA
    tensors launch ``csrc/epilogue.cu``, which reads the exposure on the
    card; CPU tensors run :func:`epilogue_plain`."""
    global launches
    with span("zoic.epilogue"):
        if tries.device.type == "cpu":
            return epilogue_plain(tries, tir, origin, direction, exposure,
                                  max_tries)
        if tries.device.type != "cuda":
            raise ValueError(f"unsupported device {tries.device}")
        b, dev, exposure = _check(tries, tir, origin, direction, exposure)
        weight, d_ody, d_ddy, stats = _launch.empty(
            dev, ((b,), torch.float32), ((b, 3), torch.float32),
            ((b, 3), torch.float32), ((4,), torch.int32))
        _launch.launch(
            _launch.bind("epilogue", "zoic_epilogue_launch", _ARGTYPES),
            "epilogue", dev, tries.data_ptr(), tir.data_ptr(),
            origin.data_ptr(), direction.data_ptr(), exposure.data_ptr(),
            weight.data_ptr(), d_ody.data_ptr(), d_ddy.data_ptr(),
            stats.data_ptr(), b, max_tries,
        )
        if b > 0:
            launches += 1
        return weight, d_ody, d_ddy, stats
