"""One-call debug render session: tape -> draw.zoic dump -> diagram PNG.

Port of ``zoic_tpu/diag/session.py``.  The reference's ``_DRAW`` flow spans
the whole node lifecycle: the dump file opens at ``node_update``
(zoic.cpp:1581-1584), the hot loop appends every 100,000th ray's element
path (zoic.cpp:1758-1764), and ``node_finish`` closes the file and shells
out to ``python draw.py`` to render the PNG (zoic.cpp:1723, 1741-1742).
This module chains the equivalents (:mod:`.tape` -> :mod:`.dump` ->
:mod:`.draw`) in-process:

* :func:`write_dump` writes ``draw.zoic`` alone and needs no matplotlib;
* :func:`write_and_render` adds the PNG, as :meth:`Camera.finish
  <zoic_tpu_torch.camera.Camera.finish>` does for the segments it gathered
  over its ``create_rays`` calls;
* :func:`render_debug_session` generates rays for one sample batch with
  ``debug.draw`` semantics and produces the dump and the PNG.
"""

from __future__ import annotations

import importlib.util
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import CameraConfig, LensModel
from ..system import CameraState, RayBatch, RayStats
from . import draw as draw_mod
from . import dump as dump_mod
from . import tape as tape_mod

DUMP_NAME = "draw.zoic"
PNG_NAME = "lensDrawing.png"


def can_render() -> bool:
    """Whether matplotlib, which draws the PNGs, is installed."""
    return importlib.util.find_spec("matplotlib") is not None


def write_dump(
    state: CameraState,
    config: CameraConfig,
    segments: List[np.ndarray],
    out_dir: str = ".",
) -> str:
    """Write ``draw.zoic`` from accumulated tape segments (``node_finish``'s
    close, zoic.cpp:1734-1740): the lens header and RAYS for the raytraced
    model, RAYS alone for the thin lens.  Returns the dump's path."""
    os.makedirs(out_dir, exist_ok=True)
    dump_path = os.path.join(out_dir, DUMP_NAME)
    segs = (
        np.concatenate([np.asarray(s) for s in segments], axis=0)
        if segments
        else np.zeros((0, 4), np.float32)
    )
    if config.lens_model is LensModel.RAYTRACED:
        dump_mod.write(
            dump_path, state.lens, segs,
            sensor_height=float(config.sensor_height),
        )
    else:
        dump_mod.write_thinlens(dump_path, segs)
    return dump_path


def write_and_render(
    state: CameraState,
    config: CameraConfig,
    segments: List[np.ndarray],
    out_dir: str = ".",
) -> str:
    """:func:`write_dump`, then the ray-diagram PNG drawn from the dump as
    written (the reference's draw.py hop, zoic.cpp:1741-1742).  Returns the
    PNG's path."""
    dump_path = write_dump(state, config, segments, out_dir)
    png_path = os.path.join(out_dir, PNG_NAME)
    draw_mod.render(dump_mod.parse_file(dump_path), png_path)
    return png_path


def render_debug_session(
    state: CameraState,
    config: CameraConfig,
    sx,
    sy,
    lensx,
    lensy,
    out_dir: str = ".",
    *,
    seed: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[str, Tuple[RayBatch, RayStats]]:
    """Generate rays for one sample batch and leave the debug artifacts the
    reference's ``_DRAW`` build would: ``draw.zoic`` + ``lensDrawing.png``
    in ``out_dir``.

    Functional one-shot equivalent of a render with ``DebugOptions.draw``
    set and :meth:`Camera.finish` (zoic.cpp:1581-1584, 1758-1764,
    1741-1745).  ``seed`` and ``generator`` key the retry draws as in
    :func:`zoic_tpu_torch.create_rays`.  Returns ``(png_path, (rays,
    stats))``.
    """
    from .. import camera as camera_mod

    rays, stats = camera_mod.create_rays(
        state, config, sx, sy, lensx, lensy, seed=seed, generator=generator
    )
    segs = tape_mod.call_tape(state, config, sx, sy, lensx, lensy, rays)
    png = write_and_render(state, config, [segs], out_dir)
    return png, (rays, stats)
