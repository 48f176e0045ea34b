"""Ray tape: batched debug recording of per-element hit points.

Port of ``zoic_tpu/diag/tape.py``.  The reference dumps every 100,000th
ray's element-by-element 2D path to ``draw.zoic`` while rendering
(zoic.cpp:1758-1764, 1121-1153).  Here a strided sub-batch of the samples
is traced once more through the eager tracer with its hit tape
(``trace.trace_stack(record_tape=True)``) on the state's device, and the
tape is read back and turned into the dump's segments on the host.  A
batch of any shape is taken flat, in order.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import pupil, trace
from ..config import CameraConfig, LensModel
from ..optics import V3
from ..sampling import concentric_disk_sample
from ..system import CameraState, RayBatch

Tensor = torch.Tensor

# a segment whose far endpoint lies beyond this |z| (cm) is an exit
# segment: the x 10,000 extension, where every lens spans a few cm
EXIT_Z = 1000.0


def _strided(a, step: int, device) -> Tensor:
    return torch.as_tensor(a, dtype=torch.float32,
                           device=device).reshape(-1)[::step]


def _host_rows(a, step: int) -> np.ndarray:
    """Every ``step``-th row of ``a`` ``[..., 3]`` as numpy, strided where
    it lies, so only those rows are read back."""
    return torch.as_tensor(a).detach().reshape(-1, 3)[::step].cpu().numpy()


def raytraced_tape(
    state: CameraState,
    config: CameraConfig,
    sx,
    sy,
    lensx,
    lensy,
    stride: Optional[int] = None,
) -> np.ndarray:
    """Trace a strided sub-batch recording hits; return [S, 4] dump segments
    (z1, y1, z2, y2), already in the dump's negated convention and with the
    final 10000-unit exit extension (zoic.cpp:1146-1153).

    Mirrors the reference's DRAW-mode framing: the drawn first attempt uses
    film x = 0 (zoic.cpp:1858-1860) and no retries.  The aperture sample is
    the concentric disk map, with image bokeh too, as in the JAX package.
    """
    lens = state.lens
    step = max(1, stride or config.debug.draw_stride)
    sx, sy, lensx, lensy = (_strided(a, step, state.device)
                            for a in (sx, sy, lensx, lensy))

    oy = sy * (state.sensor_width * 0.5)
    ox = torch.zeros_like(oy)  # draw-mode zeroes film x (zoic.cpp:1859)
    oz = torch.zeros_like(oy) + lens.origin_shift

    # the model's shaping (zoic_tpu/models/raytraced.py:_shaping_params):
    # the LUT's, or the naive first-element target (zoic.cpp:1874-1876)
    if config.kolb_sampling_lut:
        ms, tr_, sn, cs = pupil.lut_shaping(lens.lut, ox, oy)
    else:
        ms, tr_, sn, cs = ox + lens.aperture[0], ox, ox, ox + 1.0

    lx, ly = concentric_disk_sample(lensx, lensy)
    ax = lx * ms + tr_
    ay = ly * ms
    ty = ax * sn + ay * cs
    dy = ty - oy
    dz = torch.zeros_like(oy) - lens.thickness[0]
    dx = torch.zeros_like(oy)  # draw-mode zeroes dir x (zoic.cpp:1877)

    res = trace.trace_stack(
        lens, V3(ox, oy, oz), V3(dx, dy, dz), record_tape=True
    )

    # segments: film point -> hit1, hit1 -> hit2, ..., hitE -> exit*10000
    tz = res.tape_z.cpu().numpy()  # [E, S]
    ty_ = res.tape_y.cpu().numpy()
    e = tz.shape[0]
    segs = []
    prev_z, prev_y = oz.cpu().numpy(), oy.cpu().numpy()
    for i in range(e):
        hz, hy = tz[i], ty_[i]
        valid = np.isfinite(hz)
        segs.append(
            np.stack([-prev_z[valid], -prev_y[valid], -hz[valid], -hy[valid]], -1)
        )
        prev_z = np.where(valid, hz, prev_z)
        prev_y = np.where(valid, hy, prev_y)
    ok = res.ok.cpu().numpy()
    dzn = res.direction.z.cpu().numpy()
    dyn = res.direction.y.cpu().numpy()
    exit_z = prev_z + dzn * -10000.0
    exit_y = prev_y + dyn * -10000.0
    segs.append(
        np.stack([-prev_z[ok], -prev_y[ok], exit_z[ok], exit_y[ok]], -1)
    )
    return np.concatenate(segs, axis=0)


def thinlens_tape(
    state: CameraState,
    sx,
    sy,
    origin,
    direction,
    stride: int = 1,
) -> np.ndarray:
    """Thin-lens dump segments (zoic.cpp:1833-1841): origin -> far point
    along the pre-flip direction, for every ``stride``-th output ray."""
    o = _host_rows(origin, stride)
    d = _host_rows(direction, stride)
    # output dir already has z flipped; the dump uses dir.z * -10000 pre-flip
    return np.stack(
        [o[:, 2], o[:, 1], d[:, 2] * 10000.0, d[:, 1] * 10000.0], -1
    )


def call_tape(state: CameraState, config: CameraConfig, sx, sy, lensx,
              lensy, rays: RayBatch) -> np.ndarray:
    """The tape of one ``create_rays`` call in draw mode (the JAX package's
    ``Camera.create_rays``): the raytraced tape of the call's samples at
    ``debug.draw_stride``, or the thin-lens tape of its output rays."""
    if config.lens_model is LensModel.RAYTRACED:
        return raytraced_tape(state, config, sx, sy, lensx, lensy)
    return thinlens_tape(state, sx, sy, rays.origin, rays.dir,
                         stride=max(1, config.debug.draw_stride))


def segment_errors(got: np.ndarray, want: np.ndarray) -> Tuple[float, float]:
    """How far the raytraced tape ``got`` lies from ``want``, a tape of the
    same rays: ``(hit_err, exit_rel)``, the largest absolute difference of
    the hit points (every column but the exit endpoints) and the largest
    relative difference of the exit endpoints.  Raises ``ValueError`` when
    the two tapes do not have the same segments, or the exit segments are
    not the last block."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape or want.ndim != 2 or want.shape[1] != 4:
        raise ValueError(f"tapes of {got.shape} and {want.shape} segments")
    exits = np.abs(want[:, 2]) > EXIT_Z
    n_exit = int(exits.sum())
    if not exits[len(want) - n_exit:].all():
        raise ValueError("the exit segments are not the tape's last block")
    diff = np.abs(got - want)
    hit = np.concatenate([diff[:, :2].ravel(), diff[~exits, 2:].ravel()])
    ends = want[exits, 2:]
    rel = diff[exits, 2:] / np.where(ends == 0.0, 1.0, np.abs(ends))
    return (float(hit.max(initial=0.0)), float(rel.max(initial=0.0)))
