"""The W/H-phase and cost kernels' CUDA source (csrc/fused.cu), run on the CPU.

There is no card and no nvcc here, so the source is compiled with the host
C++ compiler against ``tests/cuda_emu.h``, which emulates threads, block
and warp barriers, the warp's ``mma.sync`` and ``cp.async``; the asm
helpers of fused.cu are swapped for the emulated ones and the kernel
launches for ``emu_launch``.  The library keeps fused.cu's C interface,
so it is called through the same ctypes signatures as the real one, and
its results are held against the plain versions in f64.  This checks the
kernels' indexing (fragment layouts, transposed tiles, ragged edges,
k-chunks, spans), not the card's rounding.  Imports no JAX.
"""
import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from nmf_toolbox_tpu_torch.ops.kernels import _build  # noqa: E402
from nmf_toolbox_tpu_torch.ops.kernels import fused as fk  # noqa: E402

EMU_H = _build.PKG_DIR.parent / "tests" / "cuda_emu.h"
ASM_HELPERS = ("void cp_async16", "void cp_async4", "void cp_async_commit",
               "void cp_async_wait", "void mma(")
# The emulated mma sums in f64 and rounds once; what is left is the f32
# rounding of the rest of the kernel.
REL_TOL = 1e-5


def host_source(src: str) -> str:
    """fused.cu with the emulation header, emulated asm helpers and
    emulated launches; the rest of the source is unchanged."""
    src = src.replace("#include <cuda_runtime.h>", f'#include "{EMU_H}"')
    for name in ASM_HELPERS:
        # Each helper runs from its declaration line to the closing brace
        # at the start of a line; with a template line before it if any.
        m = re.search(r"(template <int N>\n)?__device__ __forceinline__ "
                      + re.escape(name) + r".*?\n}\n", src, re.S)
        assert m, f"no {name} in fused.cu"
        src = src[:m.start()] + src[m.end():]
    src = src.replace("extern __shared__ float4 smem4[];", "float4* smem4 = emu_smem;")
    src = re.sub(r"([\w:.]+(?:<[^<>]*>)?)<<<([^>]*)>>>\(", r"emu_launch(\1, \2, ", src)
    return src


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("needs a C++20 host compiler (g++ or clang++)")
    tmp = tmp_path_factory.mktemp("fused_emu")
    cpp, so = tmp / "fused_emu.cpp", tmp / "libfused_emu.so"
    cpp.write_text(host_source((_build.CSRC / "fused.cu").read_text()))
    subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-w",
                    "-o", str(so), str(cpp)], check=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    for name, (args, res) in _build._SIGNATURES.items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = list(args)
            getattr(lib, name).restype = res
    return lib


def make(m, n, k, seed):
    rng = np.random.default_rng(seed)
    return tuple(np.ascontiguousarray(rng.uniform(0.1, 1, s).astype(np.float32))
                 for s in ((m, n), (m, k), (k, n)))


def ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def run_phase(lib, phase, V, W, H, mode):
    m, n = V.shape
    k = W.shape[1]
    shape = (m, k) if phase == 0 else (k, n)
    outs = [np.full(shape, np.nan, np.float32) for _ in range(2 if mode == "is" else 1)]
    part = np.empty(max(1, lib.nmf_phase_scratch(phase, m, n, k, fk.MODES.index(mode))),
                    np.float32)
    fn = lib.nmf_phi_dot_ht if phase == 0 else lib.nmf_wt_dot_phi
    err = fn(ptr(V), ptr(W), ptr(H), ptr(outs[0]), ptr(outs[-1]) if mode == "is" else None,
             ptr(part), m, n, k, fk.MODES.index(mode), None)
    assert err == 0
    return outs


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-6)))


# (m, n, k): one warp's rows, the MMA granule (k = 1, 8), ragged m and n
# with spans, 4-byte copies (k % 4 != 0), two and three k-chunks.
SHAPES = [(33, 47, 1), (64, 32, 8), (70, 90, 5), (257, 513, 12), (130, 101, 21),
          (40, 50, 136), (20, 40, 300)]


@pytest.mark.parametrize("name", ["phi_dot_ht", "wt_dot_phi"])
@pytest.mark.parametrize("mode", ["kl", "is"])
@pytest.mark.parametrize("m,n,k", SHAPES)
def test_emulated_phase_kernel_matches_plain_version(lib, name, mode, m, n, k):
    V, W, H = make(m, n, k, seed=m + n + k)
    got = run_phase(lib, 0 if name == "phi_dot_ht" else 1, V, W, H, mode)
    want = getattr(fk, f"{name}_reference")(
        *(torch.from_numpy(x).double() for x in (V, W, H)), mode)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == tuple(w.shape)
        assert rel(g, w.numpy()) < REL_TOL


def test_emulated_phase_plan_splits_the_loop_into_spans(lib):
    """Too few output row blocks: the W-phase at 257x513 cuts n into spans
    and the H-phase at 5000x64 cuts m (scratch asked for); a 64x32
    problem has too few tiles to cut."""
    assert lib.nmf_phase_scratch(0, 257, 513, 12, 0) > 0
    assert lib.nmf_phase_scratch(1, 5000, 64, 12, 1) > 0
    assert lib.nmf_phase_scratch(0, 64, 32, 8, 0) == 0


@pytest.mark.parametrize("mode", ["kl", "is"])
def test_emulated_cost_terms_matches_plain_version(lib, mode):
    V, W, H = make(130, 101, 21, seed=4)
    m, n = V.shape
    part = np.empty(2 * lib.nmf_cost_partials(m, n), np.float64)
    out = np.empty(2, np.float32)
    assert lib.nmf_cost_terms(ptr(V), ptr(W), ptr(H), ptr(part), ptr(out), m, n,
                              W.shape[1], fk.MODES.index(mode), None) == 0
    want = fk.cost_terms_reference(*(torch.from_numpy(x).double() for x in (V, W, H)), mode)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(out, want):
        assert abs(float(g) - float(w)) <= 1e-5 * abs(float(w))
