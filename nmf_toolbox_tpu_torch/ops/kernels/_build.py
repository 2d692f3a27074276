"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Every source is compiled at first use with ``nvcc``, one process per
source, all started together, and the objects are linked into one shared
library with a plain C interface, which is loaded with ``ctypes``; no
PyTorch header is compiled, so a build takes seconds.  The library lands
in ``nmf_toolbox_tpu_torch/_build/`` under a name that hashes the sources
and the flags, so an edited source is never served a stale build.  A
build writes to temporary files and renames the library into place, so
processes that build at once do not see each other's half-written
library.

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
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")  # the toolkit's default prefix
# sm_90a (not sm_90): the Hopper-only instructions later kernels will use
# exist only for the "a" target.  -Xptxas -v writes each kernel's
# registers, shared memory and spills to the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
    # (V, W, H, out, m, n, k, stream) -> cudaError_t
    "nmf_kl_phi_dot_ht_dma": ((_P, _P, _P, _P, _I, _I, _I, _P), _I),
    # (k) -> the dma kernel's shared memory per block, in bytes
    "nmf_dma_smem_bytes": ((_I,), ctypes.c_longlong),
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


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Where the build of the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"libnmf_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile every ``csrc/*.cu`` unless this build exists; nvcc's
    output (each kernel's registers, shared memory and spills) goes to a
    ``.log`` beside the library."""
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources()]
    tmp = out.with_name(f"{tag}.tmp")
    link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
    procs, log = [], []
    try:
        for src, obj in zip(sources(), objs):
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT,
                                                text=True)))
        for cmd, proc in procs:
            text, _ = proc.communicate()
            log.append(f"$ {' '.join(cmd)}\n{text}")
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                                   f"{' '.join(cmd)}\n{text}")
        res = subprocess.run(link, capture_output=True, text=True)
        log.append(f"$ {' '.join(link)}\n{res.stdout}{res.stderr}")
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed with code {res.returncode}:\n"
                               f"{' '.join(link)}\n{res.stderr}")
        os.replace(tmp, out)
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
        out.with_suffix(".log").write_text("\n".join(log))
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
