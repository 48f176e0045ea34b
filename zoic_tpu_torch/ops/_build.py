"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``zoic_tpu_torch/csrc/<name>.cu`` exposes a plain C interface and is
compiled on first use into ``build/zoic_tpu_torch/lib<name>-<hash>.so`` at
the repository root, where ``<hash>`` is the source's SHA-256 prefix, so an
edited source is rebuilt and an unchanged one is reused.  The target is
Hopper (``sm_90a``); fma contraction is off (``--fmad=false``) so that the
kernels round like the eager PyTorch versions they are held against.
There is no fallback: a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "zoic_tpu_torch")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
]

_LIBS: dict = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the "
            "CUDA kernels of zoic_tpu_torch are built from source at first use"
        )
    return found


def load(name: str) -> ctypes.CDLL:
    """Return the loaded library for ``csrc/<name>.cu``, building it first
    if no library of the current source exists."""
    if name in _LIBS:
        return _LIBS[name]
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {src} (rc {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, out)
    lib = ctypes.CDLL(out)
    _LIBS[name] = lib
    return lib
