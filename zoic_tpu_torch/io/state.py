"""Read a compiled-camera state file written by ``zoic_tpu.io.state.save``.

The file is one ``.npz``: ``leaf_0 .. leaf_{n-1}`` in ``jax.tree_util``
flatten order of the JAX package's ``CameraState`` plus a JSON
``__static__`` entry with the static fields.  Reading it needs numpy alone;
the leaves are named by :func:`zoic_tpu_torch.system.leaf_names` and handed
to the state bridge.  Writing states and the compile cache are not ported
yet.
"""

from __future__ import annotations

import json

import numpy as np

from ..system import CameraState, camera_state_from_numpy, leaf_names

FORMAT_VERSION = 7


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
