"""Compiled-camera state files and the on-disk compile cache.

Port of ``zoic_tpu/io/state.py``.  A state file is one ``.npz``:
``leaf_0 .. leaf_{n-1}`` in ``jax.tree_util`` flatten order of the JAX
package's ``CameraState`` (:func:`zoic_tpu_torch.system.leaf_names`) plus a
JSON ``__static__`` entry with the static fields, format v7.  Both
packages' loaders read what either package's :func:`save` writes; reading
and writing need numpy alone.  :func:`cached_compile` keeps lens compiles
across processes, keyed by the parameter tuple the reference's
``lensChanged`` compares (src/zoic.cpp:595-611) and the content of the
files the config names.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Mapping, Optional

import numpy as np
import torch

from ..config import CameraConfig
from ..system import CameraState, camera_state_from_numpy, leaf_names

FORMAT_VERSION = 7


def _static(state: CameraState) -> dict:
    """The JSON static fields, the keys ``zoic_tpu.io.state._flatten``
    writes."""
    lens, bokeh = state.lens, state.bokeh
    return {
        "format": FORMAT_VERSION,
        "has_lens": lens is not None,
        "has_bokeh": bokeh is not None,
        "has_lut": lens is not None and lens.lut is not None,
        "has_profile": lens is not None and lens.profile is not None,
        "aperture_element": (int(lens.aperture_element)
                             if lens is not None else None),
        "iris_identity": bool(lens.iris_identity) if lens is not None else False,
        "dead_frac": float(lens.dead_frac) if lens is not None else 0.0,
        "elem_flags": ([int(f) for f in lens.elem_flags]
                       if lens is not None else []),
        "profile_domain": (str(lens.profile_domain) if lens is not None
                           else "disk"),
        "profile_poly": bool(lens.profile_poly) if lens is not None else False,
        "profile_kind": (lens.profile.kind
                         if lens is not None and lens.profile is not None
                         else "harmonic"),
        "bokeh_wh": ([int(bokeh.width), int(bokeh.height)]
                     if bokeh is not None else None),
    }


def _leaf(state: CameraState, name: str) -> np.ndarray:
    obj = state
    for part in name.split("."):
        obj = getattr(obj, part)
    if obj is None:
        raise ValueError(f"state leaf {name} is None: the v{FORMAT_VERSION} "
                         "layout needs every leaf")
    return obj.detach().cpu().numpy()


def save(path: str, state: CameraState) -> None:
    """Write ``state`` to ``path`` exactly (no ``.npz`` is appended)."""
    static = _static(state)
    arrays = {f"leaf_{i}": _leaf(state, name)
              for i, name in enumerate(leaf_names(static))}
    with open(path, "wb") as f:
        np.savez(f, __static__=json.dumps(static), **arrays)


def load(path: str, device="cuda") -> CameraState:
    """Read the state file at ``path`` onto ``device`` (the card unless the
    caller asks for another)."""
    with np.load(path, allow_pickle=False) as z:
        static = json.loads(str(z["__static__"]))
        if static.get("format") != FORMAT_VERSION:
            raise ValueError(
                f"unsupported state format {static.get('format')!r} in "
                f"{path}: expected v{FORMAT_VERSION}"
            )
        names = leaf_names(static)
        n_leaves = sum(1 for k in z.files if k.startswith("leaf_"))
        if n_leaves != len(names):
            raise ValueError(
                f"{path} holds {n_leaves} leaves, the v{FORMAT_VERSION} "
                f"layout of its static fields has {len(names)}"
            )
        arrays = {name: z[f"leaf_{i}"] for i, name in enumerate(names)}
    return camera_state_from_numpy(arrays, static, device)


def cache_path(cache_dir: str, config: CameraConfig) -> str:
    """The cache file of ``config`` under ``cache_dir``: a digest of
    ``lens_key``, ``bokeh_key`` and the content of the lens and bokeh
    files (``zoic_tpu.io.state._cache_path``; the port's lens paths differ
    from the JAX package's, and so do the digests)."""
    key_parts = [repr(config.lens_key()), repr(config.bokeh_key())]
    # content-hash the files named, so that an edit invalidates the entry
    for p in (config.lens_data_path, config.bokeh_path):
        if p and os.path.exists(p):
            with open(p, "rb") as f:
                key_parts.append(hashlib.sha256(f.read()).hexdigest())
    digest = hashlib.sha256("|".join(key_parts).encode()).hexdigest()[:24]
    return os.path.join(cache_dir, f"zoic_state_{digest}.npz")


def cached_compile(
    config: CameraConfig,
    cache_dir: str,
    device="cuda",
    *,
    generator: Optional[torch.Generator] = None,
    uniforms: Optional[Mapping] = None,
) -> CameraState:
    """``compile_camera`` with a persistent on-disk cache (the
    cross-process extension of the reference's ``lensChanged``
    memoization).  A cached state is loaded onto ``device``; a missing or
    unreadable entry is compiled with the given draws and written.  The
    key does not hold the draws, as the JAX package's does not hold its
    ``lut_key``."""
    from ..camera import compile_camera

    os.makedirs(cache_dir, exist_ok=True)
    path = cache_path(cache_dir, config)
    if os.path.exists(path):
        try:
            return load(path, device)
        except (ValueError, KeyError, OSError):
            pass  # a stale or corrupt entry: compile it again
    state = compile_camera(config, device, generator=generator,
                           uniforms=uniforms)
    tmp = f"{path}.{os.getpid()}.tmp"
    save(tmp, state)
    os.replace(tmp, path)  # concurrent processes never read a partial file
    return state
