"""Data staging: load large dense matrices from disk for factorization
(the port's copy of ``nmf_toolbox_tpu/utils/io.py``).

.npy files are parsed for their header and the payload is read with the
port's native multi-threaded loader (``native/nmf_native.cpp``) when it
built, falling back to numpy.load.  Raw binary (headerless) files are
supported with an explicit shape/dtype.  ``save_matrix`` takes an array
or a tensor on any device.
"""
from __future__ import annotations

import ast
import os

import numpy as np

from .. import native
from ..core import to_host


def _npy_header(path):
    """Parse a .npy header; returns (dtype, shape, payload_offset) or None."""
    with open(path, "rb") as f:
        magic = f.read(6)
        if magic != b"\x93NUMPY":
            return None
        major, _minor = f.read(1)[0], f.read(1)[0]
        if major == 1:
            hlen = int.from_bytes(f.read(2), "little")
        else:
            hlen = int.from_bytes(f.read(4), "little")
        # The header is a Python dict literal; ast.literal_eval is the safe
        # parser for it (an eval() here would execute attacker-controlled
        # code from a crafted .npy even with empty __builtins__).
        try:
            header = ast.literal_eval(f.read(hlen).decode("latin1"))
        except (ValueError, SyntaxError):
            return None  # malformed header: let numpy.load raise its error
        if not isinstance(header, dict):
            return None
        if header.get("fortran_order"):
            return None  # fall back to numpy for F-order
        return (np.dtype(header["descr"]), tuple(header["shape"]), f.tell())


def load_matrix(path, shape=None, dtype=None, threads: int = 8) -> np.ndarray:
    """Load a dense matrix from a .npy file (shape/dtype from its header)
    or a raw binary file (shape+dtype required), using parallel native
    reads when the toolchain is available."""
    path = os.fspath(path)
    if path.endswith(".npy"):
        hdr = _npy_header(path)
        if hdr is not None and native.available():
            dt, shp, off = hdr
            out = np.empty(shp, dtype=dt)
            if native.load_bytes(path, out.reshape(-1).view(np.uint8),
                                 offset=off, threads=threads):
                return out
        return np.load(path)
    if shape is None or dtype is None:
        raise ValueError("raw binary loads need explicit shape= and dtype=")
    dt = np.dtype(dtype)
    out = np.empty(shape, dtype=dt)
    if native.available() and native.load_bytes(
            path, out.reshape(-1).view(np.uint8), offset=0, threads=threads):
        return out
    return np.fromfile(path, dtype=dt).reshape(shape)


def save_matrix(path, arr) -> None:
    """Write ``arr`` (an array, or a tensor brought to the host) as .npy
    when ``path`` ends so, else as raw C-order bytes."""
    arr = np.ascontiguousarray(to_host(arr))
    if os.fspath(path).endswith(".npy"):
        np.save(path, arr)
    else:
        arr.tofile(path)
