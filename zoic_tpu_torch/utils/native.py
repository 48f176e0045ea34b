"""ctypes bindings for the native host runtime (``native/zoic_host.cpp``).

The port's own copy of ``zoic_tpu/utils/native.py``.  The library holds the
C++ host-side pieces: the lens-file parser and cleanup (zoic.cpp:708-959
semantics) and double-precision reference solvers, which the tests hold
the port's ``lensfile`` and ``solve`` against.  Nothing on the port's
paths needs it.  It is built at first use with ``g++`` from the repo's
``native/zoic_host.cpp`` into ``build/zoic_tpu_torch/`` (the file name
holds the source's digest, so an edit rebuilds); without ``g++`` the
library is unavailable and its entry points raise.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Optional, Tuple

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(_REPO, "native", "zoic_host.cpp")
BUILD_DIR = os.path.join(_REPO, "build", "zoic_tpu_torch")
CXXFLAGS = ["-O2", "-std=c++17", "-Wall", "-fPIC", "-shared"]
ABI_VERSION = 1

_lib: Optional[ctypes.CDLL] = None
_load_failed = False

_ERRORS = {
    -1: "cannot open lens file",
    -2: "lens file contains no data rows",
    -3: "column count outside 4..5",
    -4: "ragged data row",
    -5: "multiple apertures found",
    -6: "element count exceeds capacity",
}


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libzoic_host-{digest}.so")


def build() -> bool:
    """Compile the library with ``g++`` unless it is built; returns
    success."""
    path = library_path()
    if os.path.exists(path):
        return True
    cxx = shutil.which("g++")
    if cxx is None:
        return False
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        subprocess.run([cxx, *CXXFLAGS, "-o", tmp, SOURCE], check=True,
                       capture_output=True)
    except subprocess.CalledProcessError:
        return False
    os.replace(tmp, path)  # atomic under concurrent builds
    return True


def load() -> Optional[ctypes.CDLL]:
    """Load (once) and return the library, or None if unavailable."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    if not build():
        _load_failed = True
        return None
    try:
        lib = ctypes.CDLL(library_path())
    except OSError:
        _load_failed = True
        return None
    d = ctypes.POINTER(ctypes.c_double)
    lib.zoic_parse_lens.restype = ctypes.c_int
    lib.zoic_parse_lens.argtypes = [
        ctypes.c_char_p, ctypes.c_int, d, d, d, d, d,
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.zoic_trace_focal.restype = None
    lib.zoic_trace_focal.argtypes = [d, d, d, d, ctypes.c_int, d]
    lib.zoic_image_distance.restype = ctypes.c_double
    lib.zoic_image_distance.argtypes = [d, d, d, d, ctypes.c_int,
                                        ctypes.c_double]
    lib.zoic_rescale.restype = None
    lib.zoic_rescale.argtypes = [d, d, d, ctypes.c_int, ctypes.c_double]
    lib.zoic_host_abi_version.restype = ctypes.c_int
    if lib.zoic_host_abi_version() != ABI_VERSION:
        _load_failed = True
        return None
    _lib = lib
    return _lib


def available() -> bool:
    return load() is not None


def _need() -> ctypes.CDLL:
    lib = load()
    if lib is None:
        raise RuntimeError("native host library unavailable (needs g++)")
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def parse_lens(path: str, cap: int = 64):
    """Native parse and cleanup.  Returns ``(curv, thick, ior, abbe, ap,
    aperture_element)``, the arrays float64; raises on a parse error."""
    lib = _need()
    bufs = [np.zeros(cap, np.float64) for _ in range(5)]
    ap_el = ctypes.c_int(-1)
    n = lib.zoic_parse_lens(
        path.encode(), cap, *(_ptr(b) for b in bufs), ctypes.byref(ap_el)
    )
    if n < 0:
        raise ValueError(f"zoic_parse_lens: {_ERRORS.get(n, n)}")
    return tuple(b[:n].copy() for b in bufs) + (int(ap_el.value),)


def trace_focal(curv, thick, ior, ap) -> Tuple[float, float, float]:
    """Native double-precision focal probe: ``(focal, principal_plane,
    focal_point)``."""
    lib = _need()
    arrs = [np.ascontiguousarray(a, np.float64) for a in (curv, thick, ior, ap)]
    out = np.zeros(3, np.float64)
    lib.zoic_trace_focal(*(_ptr(a) for a in arrs), len(arrs[0]), _ptr(out))
    return float(out[0]), float(out[1]), float(out[2])


def image_distance(curv, thick, ior, ap, object_distance: float) -> float:
    """Native double-precision backwards focus solve: the film-plane z."""
    lib = _need()
    arrs = [np.ascontiguousarray(a, np.float64) for a in (curv, thick, ior, ap)]
    return float(
        lib.zoic_image_distance(
            *(_ptr(a) for a in arrs), len(arrs[0]), float(object_distance)
        )
    )
