"""Native (C) components, built on first use with the system compiler and
loaded through ctypes, with pure-Python fallbacks.

Port of the JAX package's ``native/__init__.py``: the exact-DTW alignment
of the MCD evaluation runs its dynamic programme and backtrack in
``dtw.c`` (a copy of the JAX package's).  The library is built into
``build/native/libdtw_<hash>.so`` at the root of the checkout (``build/``
is git-ignored), named by the hash of the source and the flags so that an
edit rebuilds; without a compiler ``dtw_path_native`` returns None and
``ops.dtw`` runs its numpy version.  This is host code, not a device
kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

_THIS_DIR = Path(__file__).resolve().parent
BUILD_DIR = _THIS_DIR.parents[1] / "build" / "native"
CFLAGS = ("-O3", "-shared", "-fPIC")
_LIB: Optional[ctypes.CDLL] = None
_BUILD_FAILED = False


def _target() -> Path:
    h = hashlib.sha256((_THIS_DIR / "dtw.c").read_bytes())
    h.update(" ".join(CFLAGS).encode())
    return BUILD_DIR / f"libdtw_{h.hexdigest()[:12]}.so"


def _build_library() -> Optional[Path]:
    """Compile dtw.c unless its library is there; returns its path, or None
    when no compiler builds it."""
    lib_path = _target()
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for compiler in ("cc", "gcc", "clang"):
        # build to a temporary file, then move it in atomically (parallel
        # test workers)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run([compiler, *CFLAGS, str(_THIS_DIR / "dtw.c"),
                            "-o", tmp, "-lm"], check=True,
                           capture_output=True)
            os.replace(tmp, lib_path)
            return lib_path
        except (subprocess.CalledProcessError, FileNotFoundError, OSError):
            try:
                os.unlink(tmp)
            except OSError:
                pass
    return None


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _BUILD_FAILED
    if _LIB is not None or _BUILD_FAILED:
        return _LIB
    lib_path = _build_library()
    if lib_path is None:
        _BUILD_FAILED = True
        return None
    try:
        lib = ctypes.CDLL(str(lib_path))
        lib.dtw_path_from_dist.restype = ctypes.c_int
        lib.dtw_path_from_dist.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        _LIB = lib
    except OSError:
        _BUILD_FAILED = True
    return _LIB


def native_dtw_available() -> bool:
    return _load() is not None


def dtw_path_native(x: np.ndarray, y: np.ndarray):
    """Exact DTW path: pairwise Euclidean distances by one numpy matrix
    product, then the dynamic programme and backtrack in C; returns
    ``(path_x, path_y)`` (int64), or None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, dtype=np.float32)
    y = np.ascontiguousarray(y, dtype=np.float32)
    t1, d = x.shape
    t2, d2 = y.shape
    assert d == d2, "frame dimensions must match"
    sq = (x * x).sum(1)[:, None] + (y * y).sum(1)[None, :] - 2.0 * (x @ y.T)
    dist = np.ascontiguousarray(np.sqrt(np.maximum(sq, 0.0)),
                                dtype=np.float32)
    path_x = np.empty(t1 + t2, dtype=np.int32)
    path_y = np.empty(t1 + t2, dtype=np.int32)
    n = lib.dtw_path_from_dist(
        dist.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), t1, t2,
        path_x.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        path_y.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    if n < 0:
        return None
    return path_x[:n].astype(np.int64), path_y[:n].astype(np.int64)
