"""The card's published peaks (NVIDIA H100 SXM data sheet, dense, at its
full 700 W) and the power limit the card is set to, which is printed
beside every share of them."""

from __future__ import annotations

import subprocess

# float32 outside the tensor cores, an FMA counted as two FLOPs
FLOPS_F32 = 67e12
# HBM3
BYTES_PER_S = 3.35e12


def floor_s(flops: float, nbytes: float):
    """The least time the work can take on the card, and which peak bounds
    it (``"bytes"`` or ``"flops"``)."""
    t_f, t_b = flops / FLOPS_F32, nbytes / BYTES_PER_S
    return (t_b, "bytes") if t_b >= t_f else (t_f, "flops")


def card() -> str:
    """``name, power.limit`` as ``nvidia-smi`` reads them, or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else (
            "nvidia-smi read nothing")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"
