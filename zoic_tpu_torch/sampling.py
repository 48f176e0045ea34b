"""Aperture samplers of the exact eager path.

Port of ``zoic_tpu/sampling.py``: the concentric (square -> disk) map
``concentricDiskSample`` (src/zoic.cpp:686-704, the Shirley/Cline improved
mapping), op for op.  The camera kernels carry a restructured form of it
(:func:`zoic_tpu_torch.ops.trace_kernel.concentric`: one divide, the sine
polynomial shared); this one is the reference's.  The image-based bokeh
sampler lives in :mod:`zoic_tpu_torch.bokeh`.

Branches become masks; the two division-by-zero hazards (``b/a`` and
``a/b``) are guarded with ``torch.where`` picks of the branch the scalar
code takes, so results equal the reference's except at the measure-zero
input (0.5, 0.5), where the reference computes ``0 * NaN`` and this
returns (0, 0).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .optics import PI_OVER_2, PI_OVER_4, f32, fast_cos, fast_sin

Tensor = torch.Tensor


def concentric_disk_sample(ox: Tensor, oy: Tensor) -> Tuple[Tensor, Tensor]:
    """Map uniform samples on [0, 1]^2 onto the unit disk, preserving
    uniformity (``concentricDiskSample``, zoic.cpp:686-704), with the
    reference's ``fastSin``/``fastCos``: their slight warp of the disk is
    part of the reference's behaviour."""
    a = 2.0 * ox - 1.0
    b = 2.0 * oy - 1.0
    use_a = (a * a) > (b * b)
    r = torch.where(use_a, a, b)
    one = torch.ones_like(a)
    # guard both divisions; the unselected branch's value is discarded
    safe_a = torch.where(use_a, a, one)
    safe_b = torch.where(use_a, one, torch.where(b == 0.0, one, b))
    phi = torch.where(
        use_a,
        f32(PI_OVER_4) * (b / safe_a),
        f32(PI_OVER_2) - f32(PI_OVER_4) * (a / safe_b),
    )
    return r * fast_cos(phi), r * fast_sin(phi)
