"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Every source is compiled at first use with ``nvcc``, one process per
source, all started together (the ``csrc/*.cuh`` headers they include
are hashed with them), and the objects are linked into one shared
library with a plain C interface, which is loaded with ``ctypes``; no
PyTorch header is compiled, so a build takes seconds.  The library lands
in :func:`build_dir` (``nmf_toolbox_tpu_torch/_build/``, or the user's
``~/.cache/nmf_toolbox_tpu_torch/_build`` where an installed package
cannot be written) under a name that hashes the sources and the flags,
so an edited source is never served a stale build.  A build writes to
files named for its process and renames the library and its log into
place, under a lock that processes starting at once take in turn, so
none of them loads or reads a half-written file.

``nvcc`` is found through ``CUDA_HOME``, then ``PATH``, then the
toolkit's default prefix ``/usr/local/cuda``; without it :func:`load`
raises.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC = PKG_DIR / "csrc"
PKG_BUILD_DIR = PKG_DIR / "_build"
CACHE_BUILD_DIR = Path.home() / ".cache" / "nmf_toolbox_tpu_torch" / "_build"
DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")  # the toolkit's default prefix
# sm_90a (not sm_90): the Hopper-only instructions later kernels will use
# exist only for the "a" target.  -Xptxas -v writes each kernel's
# registers, shared memory and spills to the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_D = ctypes.c_double
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
    # (k, int[4] out: rows, warps, column groups, blocks per SM)
    # -> the dma kernel's tier for k (-1 outside 1..512)
    "nmf_dma_tier": ((_I, _P), _I),
    # (S, v, done, iters, B, B1, N, valid, s0, s1, v0, v1,
    #  k1, k1 stride, k1 value, k2, k2 stride, k2 value, passes, is_double,
    #  stream) -> cudaError_t
    "nmf_hoyer_project": ((_P, _P, _P, _P, _L, _L, _I, _I, _L, _L, _L, _L,
                           _P, _L, _D, _P, _L, _D, _I, _I, _P), _I),
    # (N, is_double, int[3] out: threads, entries per thread, CTAs per
    # vector) -> the Hoyer projection's tier for N (-1 for N < 1)
    "nmf_hoyer_tier": ((_I, _I, _P), _I),
    # (V, V_hat, M or NULL, phi, entries, stream) -> cudaError_t
    "nmf_kl_field": ((_P, _P, _P, _P, _L, _P), _I),
    # (entries, weighted) -> doubles of scratch nmf_kl_cost needs
    "nmf_kl_cost_partials": ((_L, _I), _L),
    # (V, V_hat, M or NULL, partials, out, entries, stream) -> cudaError_t
    "nmf_kl_cost": ((_P, _P, _P, _P, _P, _L, _P), _I),
}


def build_dir() -> Path:
    """Where builds go: the package's ``_build/`` when it can be written
    (a checkout, an editable install), else the user's cache directory
    (a read-only site-packages).  Created on first call."""
    for d in (PKG_BUILD_DIR, CACHE_BUILD_DIR):
        try:
            d.mkdir(parents=True, exist_ok=True)
        except OSError:
            continue
        if os.access(d, os.W_OK | os.X_OK):
            return d
    raise RuntimeError(f"neither {PKG_BUILD_DIR} nor {CACHE_BUILD_DIR} can be "
                       "written; nmf_toolbox_tpu_torch cannot build its libraries")


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
    """The sources nvcc compiles, one object each."""
    return sorted(CSRC.glob("*.cu"))


def headers() -> list[Path]:
    """The headers the sources include."""
    return sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the build of the current sources, headers and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + headers():
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return build_dir() / f"libnmf_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile every ``csrc/*.cu`` unless this build exists; nvcc's
    output (each kernel's registers, shared memory and spills) goes to a
    ``.log`` beside the library.  Processes that start at once (the ranks
    of a mesh) take turns on a lock beside the library, so one builds and
    the others load its build; a process that dies releases the lock."""
    out = library_path()
    if out.is_file():
        return out
    with open(out.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.is_file():
            _compile(out)
    return out


def _compile(out: Path):
    """Build the library at ``out``: objects, library and log under names
    of this process, the library and then its log renamed into place."""
    nvcc = nvcc_path()
    tag = f"{out.stem}.{os.getpid()}"
    objs = [out.parent / f"{tag}.{src.stem}.o" for src in sources()]
    tmp, tmp_log = out.with_name(f"{tag}.tmp"), out.with_name(f"{tag}.log")
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
        tmp_log.write_text("\n".join(log))
        os.replace(tmp_log, out.with_suffix(".log"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Type the entry points that ``lib`` has for ctypes."""
    for name, (args, res) in _SIGNATURES.items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = list(args)
            getattr(lib, name).restype = res
    return lib


@functools.cache
def load() -> ctypes.CDLL:
    """The kernel library, built on first use and typed for ctypes."""
    return bind(ctypes.CDLL(str(build())))
