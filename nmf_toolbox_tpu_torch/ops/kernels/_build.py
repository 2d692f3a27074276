"""Build and load the hand-written CUDA kernels (``csrc/fused.cu``).

The source is compiled at first use with ``nvcc`` into a shared library
with a plain C interface, which is loaded with ``ctypes``; no PyTorch
header is compiled, so a build takes seconds.  The library lands in
``nmf_toolbox_tpu_torch/_build/`` under a name that hashes the source and
the flags, so an edited source is never served a stale build.  A build
writes to a temporary file and renames it into place, so processes that
build at once do not see each other's half-written library.

``nvcc`` is found through ``CUDA_HOME``, then ``PATH``, then the
toolkit's default prefix ``/usr/local/cuda``; without it :func:`load`
raises.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
SOURCE = PKG_DIR / "csrc" / "fused.cu"
BUILD_DIR = PKG_DIR / "_build"
DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")  # the toolkit's default prefix
# sm_90a (not sm_90): the Hopper-only instructions later kernels will use
# exist only for the "a" target.  -Xptxas -v writes each kernel's
# registers, shared memory and spills to the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # (V, W, H, out1, out2, scratch, m, n, k, mode, stream) -> cudaError_t
    "nmf_phi_dot_ht": ((_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P), _I),
    "nmf_wt_dot_phi": ((_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P), _I),
    # (phase, m, n, k, mode) -> floats of scratch
    "nmf_phase_scratch": ((_I, _I, _I, _I, _I), ctypes.c_longlong),
    # (V, W, H, partials, out, m, n, k, mode, stream) -> cudaError_t
    "nmf_cost_terms": ((_P, _P, _P, _P, _P, _I, _I, _I, _I, _P), _I),
    # (m, n) -> partial sums per output
    "nmf_cost_partials": ((_I, _I), ctypes.c_longlong),
    "nmf_error_string": ((_I,), ctypes.c_char_p),
}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(DEFAULT_NVCC)
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build nmf_toolbox_tpu_torch's CUDA kernels")


def library_path() -> Path:
    """Where the build of the current source and flags lives."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libnmf_fused_{digest}.so"


def build() -> Path:
    """Compile ``csrc/fused.cu`` unless this source's build exists;
    nvcc's output goes to a ``.log`` beside the library."""
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                           f"{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.cache
def load() -> ctypes.CDLL:
    """The kernel library, built on first use and typed for ctypes."""
    lib = ctypes.CDLL(str(build()))
    for name, (args, res) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(args)
        fn.restype = res
    return lib
