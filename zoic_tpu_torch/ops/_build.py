"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``zoic_tpu_torch/csrc/<name>.cu`` exposes a plain C interface and is
compiled on first use into ``build/zoic_tpu_torch/lib<name>-<hash>.so`` at
the repository root, where ``<hash>`` is a SHA-256 prefix over the source and
every shared header ``csrc/*.cuh``, so an edit to either is rebuilt and an
unchanged tree is reused.  :func:`load_all` builds several sources at once,
one ``nvcc`` process each.  The target is
Hopper (``sm_90a``); fma contraction is off (``--fmad=false``) so that the
kernels round like the eager PyTorch versions they are held against.  A
source can also be built with contraction on (``fmad=True``), as a library
of its own (``lib<name>-fmad-<hash>.so``): the op-rate microbenchmark
measures both builds.  There is no fallback: a failed build raises.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, Tuple, Union

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


def source_digest(name: str) -> str:
    """SHA-256 prefix over ``csrc/<name>.cu`` and every ``csrc/*.cuh`` (by
    file name and content), the key of the built library."""
    h = hashlib.sha256()
    headers = sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    for path in [os.path.join(CSRC, f"{name}.cu"), *headers]:
        with open(path, "rb") as f:
            data = f.read()
        h.update(os.path.basename(path).encode())
        h.update(len(data).to_bytes(8, "little"))
        h.update(data)
    return h.hexdigest()[:16]


def load(name: str, fmad: bool = False) -> ctypes.CDLL:
    """Return the loaded library for ``csrc/<name>.cu``, building it first
    if no library of the current sources exists; ``fmad`` builds it with
    fma contraction on."""
    if (name, fmad) in _LIBS:
        return _LIBS[(name, fmad)]
    src = os.path.join(CSRC, f"{name}.cu")
    tag = f"{name}-fmad" if fmad else name
    out = os.path.join(BUILD_DIR, f"lib{tag}-{source_digest(name)}.so")
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        flags = [("--fmad=true" if fmad and f == "--fmad=false" else f)
                 for f in NVCC_FLAGS]
        cmd = [_nvcc(), *flags, "-o", tmp, src]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {src} (rc {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, out)
    lib = ctypes.CDLL(out)
    _LIBS[(name, fmad)] = lib
    return lib


def load_all(
    builds: Iterable[Union[str, Tuple[str, bool]]]
) -> Dict[Union[str, Tuple[str, bool]], ctypes.CDLL]:
    """:func:`load` for several builds, each a source name or a ``(name,
    fmad)`` pair, their ``nvcc`` runs in parallel."""
    builds = list(builds)

    def one(b):
        return load(b) if isinstance(b, str) else load(*b)

    with ThreadPoolExecutor(max_workers=max(1, len(builds))) as pool:
        return dict(zip(builds, pool.map(one, builds)))
