"""Vectorized geometric-optics primitives on tensors.

Port of ``zoic_tpu/optics.py:40-224``, the reference's optics math
(src/zoic.cpp:973-1049):

* ``raySphereIntersection``       (zoic.cpp:973-995)  -> :func:`ray_sphere_intersect`
* ``intersectionNormal``          (zoic.cpp:999-1004) -> :func:`sphere_normal`
* ``calculateTransmissionVector`` (zoic.cpp:1008-1025)-> :func:`refract`
* ``lineLineIntersection``        (zoic.cpp:1029-1039)-> :func:`line_line_zy`
* ``linePlaneIntersection``       (zoic.cpp:1043-1049)-> :func:`line_plane_y0`
* ``fastSin``/``fastCos``         (zoic.cpp:661-681)  -> :func:`fast_sin`/:func:`fast_cos`
* ``linearInterpolate``           (zoic.cpp:655-657)  -> :func:`lerp`

Vectors are ``(x, y, z)`` triples of float32 tensors of any broadcastable
shape; branches are masks.  Each function keeps the JAX function's order of
operations, and every Python constant is rounded to float32 where JAX's weak
typing rounds it.  The square root is correctly rounded on every device
(:func:`sqrt`), and the reciprocal square root is its IEEE reciprocal
(:func:`rsqrt`), so a compile gives the same bits on the CPU and on the
card.  XLA's CPU ``rsqrt`` is an approximation instead, 1 ulp off on about
one input in seven: that, not the order of operations, is where the two
packages part (``tests/test_torch_lensfile_solve.py``).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple, Union

import numpy as np
import torch

Tensor = torch.Tensor
Scalar = Union[float, Tensor]


def f32(x: float) -> float:
    """A Python constant rounded to float32, as JAX's weak typing rounds it."""
    return float(np.float32(x))


def div(a: Tensor, b) -> Tensor:
    """``a / b`` by true division.  A Python number ``b`` becomes a 0-d
    float32 tensor on ``a``'s device first: PyTorch computes a tensor over a
    host scalar on the card as a multiply by its reciprocal, one ulp off."""
    if not isinstance(b, Tensor):
        b = torch.tensor(b, dtype=torch.float32, device=a.device)
    return a / b


def sqrt(x: Tensor) -> Tensor:
    """Correctly rounded float32 square root.  PyTorch's CPU kernel is not
    (it is 1 ulp off on some inputs, where XLA and CUDA's ``sqrtf`` are
    exact), so on the CPU the root is taken in float64 and rounded once."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).to(x.dtype)
    return torch.sqrt(x)


def rsqrt(x: Tensor) -> Tensor:
    """``1 / sqrt(x)``, both steps correctly rounded, on every device (CUDA's
    ``rsqrtf`` behind ``torch.rsqrt`` is an approximation)."""
    return torch.reciprocal(sqrt(x))


def cos(x: Tensor) -> Tensor:
    """float32 cosine rounded from float64, the same bits on every device."""
    return torch.cos(x.double()).to(x.dtype)


def sin(x: Tensor) -> Tensor:
    """float32 sine rounded from float64, the same bits on every device."""
    return torch.sin(x.double()).to(x.dtype)


# float32 pi, matching Arnold's AI_PI literal in float arithmetic.
PI = 3.14159265358979323
PI_OVER_2 = PI / 2.0
PI_OVER_4 = 0.78539816339  # literal used by the reference (zoic.cpp:695)


class V3(NamedTuple):
    """A 3-vector as three same-shaped tensors (SoA)."""

    x: Tensor
    y: Tensor
    z: Tensor

    def __add__(self, o: "V3") -> "V3":
        return V3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o: "V3") -> "V3":
        return V3(self.x - o.x, self.y - o.y, self.z - o.z)

    def scale(self, s: Scalar) -> "V3":
        return V3(self.x * s, self.y * s, self.z * s)

    def neg(self) -> "V3":
        return V3(-self.x, -self.y, -self.z)


def v3(x: Scalar, y: Scalar, z: Scalar, device=None) -> V3:
    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    return V3(t(x), t(y), t(z))


def dot(a: V3, b: V3) -> Tensor:
    return a.x * b.x + a.y * b.y + a.z * b.z


def norm2(a: V3) -> Tensor:
    return dot(a, a)


def normalize(a: V3) -> V3:
    """AiV3Normalize equivalent: a / |a| via rsqrt."""
    return a.scale(rsqrt(norm2(a)))


def where_v3(mask: Tensor, a: V3, b: V3) -> V3:
    return V3(
        torch.where(mask, a.x, b.x),
        torch.where(mask, a.y, b.y),
        torch.where(mask, a.z, b.z),
    )


def lerp(perc: Scalar, a: Scalar, b: Scalar) -> Tensor:
    """linearInterpolate (zoic.cpp:655-657): a + perc * (b - a)."""
    return a + perc * (b - a)


def fast_sin(x: Tensor) -> Tensor:
    """The reference's Bhaskara-style sine approximation (zoic.cpp:661-668),
    op for op.  Assumes ``x + pi >= 0`` (true for every call site)."""
    x = torch.fmod(x + f32(PI), f32(PI * 2)) - f32(PI)
    y = f32(4.0 / PI) * x + f32(-4.0 / (PI * PI)) * x * torch.abs(x)
    return f32(0.225) * (y * torch.abs(y) - y) + y


def fast_cos(x: Tensor) -> Tensor:
    """fastCos (zoic.cpp:671-681): fast_sin shifted by pi/2."""
    return fast_sin(x + f32(PI * 0.5))


def _sign(radius: Tensor) -> Tensor:
    return torch.where(radius < 0.0, -1.0, 1.0).to(torch.float32)


def ray_sphere_intersect(
    origin: V3,
    direction: V3,
    center_z: Scalar,
    radius: Tensor,
    *,
    reverse: bool,
    cull_miss: bool,
) -> Tuple[V3, Tensor]:
    """Ray/sphere intersection for an on-axis sphere at ``(0, 0, center_z)``
    (``raySphereIntersection``, zoic.cpp:973-995).  The direction is
    normalized here; a signed radius picks the surface facing the ray and
    ``reverse`` the near solution.  With ``cull_miss`` a ray whose closest
    approach exceeds |radius| misses; otherwise the square root of the
    absolute discriminant keeps the trace alive.  Returns ``(hit, miss)``;
    ``hit`` is undefined where ``miss``."""
    d = normalize(direction)
    L = V3(0.0 - origin.x, 0.0 - origin.y, center_z - origin.z)
    tca = dot(L, d)
    r2 = radius * radius
    d2 = norm2(L) - tca * tca
    miss = (d2 > r2) if cull_miss else torch.zeros_like(tca, dtype=torch.bool)
    thc = sqrt(torch.abs(r2 - d2))
    sign = _sign(radius)
    t = tca - thc * sign if reverse else tca + thc * sign
    return origin + d.scale(t), miss


def sphere_normal(hit: V3, center_z: Scalar, radius: Tensor) -> V3:
    """Surface normal at ``hit`` on the on-axis sphere (zoic.cpp:999-1004):
    ``normalize(center - hit) * sign(radius)``."""
    c = V3(0.0 - hit.x, 0.0 - hit.y, center_z - hit.z)
    return normalize(c).scale(_sign(radius))


def refract(
    incident: V3,
    normal: V3,
    ior1: Tensor,
    ior2: Tensor,
    *,
    check_tir: bool,
) -> Tuple[V3, Tensor]:
    """Snell refraction (``calculateTransmissionVector``, zoic.cpp:1008-1025).
    ``eta = ior1 / ior2``; total internal reflection is flagged only when
    ``check_tir`` and ``ior1 > ior2``, and the refracted vector is produced
    with ``sqrt(abs(1 - cs2))`` regardless.  Returns ``(transmitted, tir)``."""
    i = normalize(incident)
    n = normalize(normal)
    eta = ior1 / ior2
    c1 = -dot(i, n)
    cs2 = (eta * eta) * (1.0 - c1 * c1)
    if check_tir:
        tir = (ior1 > ior2) & (cs2 > 1.0)
    else:
        tir = torch.zeros_like(cs2, dtype=torch.bool)
    k = eta * c1 - sqrt(torch.abs(1.0 - cs2))
    t = V3(i.x * eta + n.x * k, i.y * eta + n.y * k, i.z * eta + n.z * k)
    return t, tir


def line_plane_y0(origin: V3, direction: V3) -> V3:
    """Intersection of a ray with the plane y = 0
    (``linePlaneIntersection``, zoic.cpp:1043-1049):
    ``origin + d_norm * (-origin.y / d_norm.y)``."""
    d = normalize(direction)
    t = (0.0 - origin.y) / d.y
    return origin + d.scale(t)


def line_line_zy(p1: V3, p2: V3, p3: V3, p4: V3) -> Tuple[Tensor, Tensor]:
    """2D line-line intersection in the (z, y) plane through point pairs
    (p1, p2) and (p3, p4) (``lineLineIntersection``, zoic.cpp:1029-1039).
    Returns ``(z, y)``."""
    a1 = p2.y - p1.y
    b1 = p1.z - p2.z
    c1 = a1 * p1.z + b1 * p1.y
    a2 = p4.y - p3.y
    b2 = p3.z - p4.z
    c2 = a2 * p3.z + b2 * p3.y
    delta = a1 * b2 - a2 * b1
    return (b2 * c1 - b1 * c2) / delta, (a1 * c2 - a2 * c1) / delta
