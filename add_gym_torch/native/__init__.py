"""ctypes bindings for the native C++ data loader (``loader.cpp``).

Counterpart of ``add_gym_tpu/native``.  The library is built with g++ at
first use into ``build/add_gym_torch/`` beside the package (the file name
carries a hash of the source and flags, so an edit rebuilds), never next
to the source.  Every entry point has a numpy fallback, so the package
works without a toolchain: the native path is a host-side speed-up of the
data loading, not a dependency.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build", "add_gym_torch")
SOURCE = os.path.join(_DIR, "loader.cpp")
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-shared")

_lib = None
_build_attempted = False


def library_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libagtnative_{h.hexdigest()[:16]}.so")


def build_library() -> str:
    """Compile the library with g++ if it is not built yet; returns its
    path.  Raises if there is no compiler or the build fails."""
    path = library_path()
    if os.path.exists(path):
        return path
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no g++ on PATH to build the native loader")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE], check=True, capture_output=True,
                   timeout=120)
    os.replace(tmp, path)
    return path


def _load():
    global _lib, _build_attempted
    if _lib is not None or _build_attempted:
        return _lib
    _build_attempted = True
    try:
        lib = ctypes.CDLL(build_library())
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return None
    lib.agt_parse_motion_csv.restype = ctypes.c_int
    lib.agt_parse_motion_csv.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.agt_free.restype = None
    lib.agt_free.argtypes = [ctypes.c_void_p]
    lib.agt_stl_aabb.restype = ctypes.c_int
    lib.agt_stl_aabb.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
    ]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def parse_motion_csv(path: str) -> np.ndarray:
    """Parse a ``.motion`` CSV into a [T, C] float64 array (native if possible)."""
    lib = _load()
    if lib is None:
        return np.atleast_2d(np.loadtxt(path, delimiter=",", dtype=np.float64))
    out = ctypes.POINTER(ctypes.c_double)()
    rows = ctypes.c_int64()
    cols = ctypes.c_int64()
    rc = lib.agt_parse_motion_csv(
        path.encode(), ctypes.byref(out), ctypes.byref(rows), ctypes.byref(cols)
    )
    if rc != 0:
        raise IOError(f"agt_parse_motion_csv({path!r}) failed with code {rc}")
    try:
        n = rows.value * cols.value
        arr = np.ctypeslib.as_array(out, shape=(n,)).copy()
    finally:
        lib.agt_free(out)
    return arr.reshape(rows.value, cols.value)


def stl_aabb(path: str):
    """AABB (lo, hi) of a binary STL (native if possible)."""
    lib = _load()
    if lib is None:
        from add_gym_torch.physics.stl import stl_aabb as py_stl_aabb

        return py_stl_aabb(path)
    lo = (ctypes.c_float * 3)()
    hi = (ctypes.c_float * 3)()
    rc = lib.agt_stl_aabb(path.encode(), lo, hi)
    if rc != 0:
        raise IOError(f"agt_stl_aabb({path!r}) failed with code {rc}")
    return np.array(lo, np.float32), np.array(hi, np.float32)
