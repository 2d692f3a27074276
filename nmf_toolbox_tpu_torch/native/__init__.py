"""ctypes bridge to the native host runtime (``nmf_native.cpp``).

The port's own copy of ``nmf_toolbox_tpu/native``.  The source is
compiled with ``g++`` at first use into the port's build directory
(``ops.kernels._build.build_dir``), under a name that hashes the source
and the flags, so an edited source is never served a stale library; the
build writes a temporary file and renames it into place.  Every entry
point has a pure-Python fallback (it returns None or False and the
caller takes its own path), so the package works without a toolchain.
Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "nmf_native.cpp"
# No -march=native: the library may be built on one host and loaded on
# another that shares the build directory.
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> Path:
    """Where the build of the current source and flags lives."""
    from ..ops.kernels._build import build_dir
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode() + b"\0" + SRC.read_bytes())
    return build_dir() / f"libnmf_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``nmf_native.cpp`` unless this build exists."""
    out = library_path()
    if out.is_file():
        return out
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(build()))
            lib.convhull2d.restype = ctypes.c_int
            lib.convhull2d.argtypes = [
                ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64)]
            lib.load_bytes.restype = ctypes.c_int
            lib.load_bytes.argtypes = [
                ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int]
            _lib = lib
        except Exception:
            _lib = None
        return _lib


def available() -> bool:
    """Whether the native library built and loaded."""
    return _load() is not None


def convhull2d(points: np.ndarray) -> np.ndarray | None:
    """Hull indices of (n, 2) points via the native monotone chain;
    None when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    pts = np.ascontiguousarray(points, dtype=np.float64)
    n = pts.shape[0]
    out = np.empty(n if n > 2 else 2, dtype=np.int64)
    cnt = lib.convhull2d(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_int64(n),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if cnt < 0:
        return None
    return np.unique(out[:cnt])


def load_bytes(path: str, dst: np.ndarray, offset: int = 0,
               threads: int = 8) -> bool:
    """Fill ``dst`` (contiguous) from ``path`` starting at byte ``offset``
    with multi-threaded reads.  Returns False when unavailable/failed."""
    if not dst.flags["C_CONTIGUOUS"]:
        raise ValueError("load_bytes fills a C-contiguous array only")
    lib = _load()
    if lib is None:
        return False
    rc = lib.load_bytes(os.fspath(path).encode(),
                        dst.ctypes.data_as(ctypes.c_void_p),
                        ctypes.c_int64(offset), ctypes.c_int64(dst.nbytes),
                        ctypes.c_int(threads))
    return rc == 0
