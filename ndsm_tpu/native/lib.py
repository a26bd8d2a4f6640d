"""ctypes bindings for the native CPU core (ndsm_core.cc).

Mirrors the reference's Python->native boundary (ndsm.py:136-207 loading
ndsmf.so via ctypes) but with explicit build management and numpy-native
marshalling.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from typing import Optional, Sequence

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "ndsm_core.cc")
#: Build output directory (listed in .gitignore: binaries are never
#: committed, each checkout builds its own from ndsm_core.cc).
_BUILD_DIR = os.path.join(_HERE, "_build")
_CXXFLAGS = ("-O3", "-fPIC", "-shared", "-fopenmp", "-std=c++17")

_lib: Optional[ctypes.CDLL] = None


def _so_path() -> str:
    """Library path keyed by the source and the flags, so an edited
    source or a changed flag set can never load a stale binary."""
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(_CXXFLAGS).encode())
    return os.path.join(_BUILD_DIR, f"libndsm_core-{h.hexdigest()[:16]}.so")


def build(force: bool = False) -> str:
    """Compile the shared library with g++ (portable flags: no
    ``-march=native``) into ``_build/``.  Returns its path.  The output
    is written under a temporary name and renamed into place, so
    concurrent first uses (parallel test workers) never load a
    half-written file."""
    so = _so_path()
    if force or not os.path.exists(so):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(
                ["g++", *_CXXFLAGS, _SRC, "-o", tmp],
                check=True,
                capture_output=True,
            )
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return so


def get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        path = build()
        lib = ctypes.CDLL(path)
        i64p = np.ctypeslib.ndpointer(np.int64, flags=("C", "A"))
        f64p = np.ctypeslib.ndpointer(np.float64, flags=("C", "A"))
        f64pw = np.ctypeslib.ndpointer(np.float64, flags=("C", "A", "W"))
        lib.ndsm_rb_sweep_3d.argtypes = [f64pw, f64p, i64p, f64p, ctypes.c_char_p]
        lib.ndsm_rb_sweep_3d.restype = None
        lib.ndsm_residual_3d.argtypes = [f64p, f64p, f64pw, i64p, f64p, ctypes.c_char_p]
        lib.ndsm_residual_3d.restype = None
        lib.ndsm_rb_sweep_nd.argtypes = [
            f64pw,
            f64p,
            ctypes.c_int64,
            i64p,
            f64p,
            ctypes.c_char_p,
        ]
        lib.ndsm_rb_sweep_nd.restype = None
        lib.ndsm_apply_axis_matrix.argtypes = [
            f64p,
            f64pw,
            f64p,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
        ]
        lib.ndsm_apply_axis_matrix.restype = None
        lib.ndsm_native_nthreads.restype = ctypes.c_int
        _lib = lib
    return _lib


def available() -> bool:
    try:
        get_lib()
        return True
    except Exception:
        return False


def _bcs_bytes(bcs: Sequence[Sequence[str]]) -> bytes:
    return "".join(lo + hi for lo, hi in [(b[0], b[1]) for b in bcs]).encode()


def rb_sweep_3d(u: np.ndarray, rhs: np.ndarray, dq, bcs) -> np.ndarray:
    """One red-black Gauss-Seidel sweep (returns a new array)."""
    lib = get_lib()
    u = np.ascontiguousarray(u, dtype=np.float64).copy()
    rhs = np.ascontiguousarray(rhs, dtype=np.float64)
    shape = np.asarray(u.shape, dtype=np.int64)
    dq = np.ascontiguousarray(dq, dtype=np.float64)
    lib.ndsm_rb_sweep_3d(u, rhs, shape, dq, _bcs_bytes(bcs))
    return u


def rb_sweep_nd(u: np.ndarray, rhs: np.ndarray, dq, bcs) -> np.ndarray:
    # The C kernel uses a fixed idx[16] scratch (ndsm_core.cc); reject
    # higher ranks cleanly instead of corrupting the stack.
    if u.ndim > 16:
        raise ValueError(f"rb_sweep_nd supports ndim <= 16, got {u.ndim}")
    lib = get_lib()
    u = np.ascontiguousarray(u, dtype=np.float64).copy()
    rhs = np.ascontiguousarray(rhs, dtype=np.float64)
    shape = np.asarray(u.shape, dtype=np.int64)
    dq = np.ascontiguousarray(dq, dtype=np.float64)
    lib.ndsm_rb_sweep_nd(u, rhs, np.int64(u.ndim), shape, dq, _bcs_bytes(bcs))
    return u


def residual_3d(u: np.ndarray, rhs: np.ndarray, dq, bcs) -> np.ndarray:
    lib = get_lib()
    u = np.ascontiguousarray(u, dtype=np.float64)
    rhs = np.ascontiguousarray(rhs, dtype=np.float64)
    r = np.zeros_like(u)
    shape = np.asarray(u.shape, dtype=np.int64)
    dq = np.ascontiguousarray(dq, dtype=np.float64)
    lib.ndsm_residual_3d(u, rhs, r, shape, dq, _bcs_bytes(bcs))
    return r
