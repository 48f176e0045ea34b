"""Ray-diagram renderer: lens cross-section + traced rays to PNG.

The port's own copy of ``zoic_tpu/diag/draw.py``, a matplotlib port of the
reference's ``src/draw.py`` (Python2/PIL): lens element arcs from (center,
radius, half-angle), iris and max-aperture markers, sensor line,
focus/image-distance verticals, and the traced ray segments.  Consumes the
dump dict that :mod:`zoic_tpu_torch.diag.dump` parses, so it renders the
port's dumps, the JAX package's and the reference plugin's (e.g. the
checked-in ``src/draw.zoic``).  matplotlib is imported by :func:`render`
only: the rest of the package runs without it.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def render(
    dump: Dict[str, np.ndarray],
    out_path: str,
    *,
    xlim: Optional[tuple] = None,
    dpi: int = 150,
) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(15, 2.5), dpi=dpi)

    rays = dump.get("RAYS")
    if rays is not None and len(rays):
        ax.plot(
            rays[:, [0, 2]].T,
            rays[:, [1, 3]].T,
            color="#d4aa33",
            lw=0.25,
            alpha=0.5,
            zorder=1,
        )

    lenses = dump.get("LENSES")
    if lenses is not None:
        for cz, radius, half_angle in lenses:
            if not np.isfinite(half_angle):
                half_angle = 90.0
            th = np.radians(np.linspace(-half_angle, half_angle, 65))
            # arc of the sphere at (cz, 0): points = center + R*(cos, sin)
            ax.plot(
                cz + radius * np.cos(th),
                radius * np.sin(th),
                color="#444",
                lw=0.9,
                zorder=2,
            )

    def vline(key, color, label):
        v = dump.get(key)
        if v is not None and np.size(v):
            ax.axvline(float(np.ravel(v)[0]), color=color, lw=0.7, ls="--", label=label)

    vline("IMAGEDISTANCE", "#3377cc", "image plane")
    vline("FOCUSDISTANCE", "#cc3333", "focus distance")

    ap = dump.get("APERTURE")
    apd = dump.get("APERTUREDISTANCE")
    apm = dump.get("APERTUREMAX")
    if ap is not None and apd is not None and apm is not None:
        z = float(np.ravel(apd)[0])
        r = float(np.ravel(ap)[0])
        m = float(np.ravel(apm)[0])
        ax.plot([z, z], [r, m], color="#222", lw=2.0, zorder=3)
        ax.plot([z, z], [-r, -m], color="#222", lw=2.0, zorder=3)

    sh = dump.get("SENSORHEIGHT")
    img = dump.get("IMAGEDISTANCE")
    if sh is not None and img is not None and np.size(img):
        z = float(np.ravel(img)[0])
        h = float(np.ravel(sh)[0])
        ax.plot([z, z], [-h, h], color="#000", lw=2.5, zorder=3)

    if xlim:
        ax.set_xlim(*xlim)
    else:
        if lenses is not None and img is not None and np.size(img):
            z0 = float(np.ravel(img)[0])
            z1 = float(np.max(lenses[:, 0] + np.abs(lenses[:, 1]) * 0.2))
            span = z1 - z0
            ax.set_xlim(z0 - 0.05 * span, z1 + 0.4 * span)
    ax.set_aspect("equal", adjustable="datalim")
    ax.set_xlabel("z [cm]")
    ax.set_ylabel("y [cm]")
    ax.legend(loc="upper right", fontsize=6)
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)
