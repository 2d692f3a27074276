"""The kernels' CUDA sources (csrc/fused.cu, csrc/fused_dma.cu), run on the CPU.

There is no card and no nvcc here, so each source is compiled with the
host C++ compiler against ``tests/cuda_emu.h``, which emulates threads,
block and warp barriers, the warp's ``mma.sync`` and ``cp.async``; the
csrc headers a source includes are inlined, their asm helpers swapped
for the emulated ones and the kernel launches for ``emu_launch``.  Each
library keeps its source's C interface, so it is called through the same
ctypes signatures as the real one, and its results are held against the
plain versions in f64.  This checks the kernels' indexing (fragment
layouts, transposed tiles, ragged edges, k-chunks, spans, the dma
kernel's tiers), not the card's rounding.  Imports no JAX.
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
from nmf_toolbox_tpu_torch.ops.kernels import fused_dma as dk  # noqa: E402

EMU_H = _build.PKG_DIR.parent / "tests" / "cuda_emu.h"
# The asm helpers of csrc/tile_ops.cuh, each with an emulated twin in
# cuda_emu.h.
ASM_HELPERS = ("void cp_async16", "void cp_async4", "void cp_async_commit",
               "void cp_async_wait", "void mma(")
# The emulated mma sums in f64 and rounds once; what is left is the f32
# rounding of the rest of the kernel.
REL_TOL = 1e-5


def host_source(path, helpers=ASM_HELPERS) -> str:
    """The CUDA source at ``path`` with the csrc headers it includes
    inlined, the emulation header, emulated asm ``helpers`` and emulated
    launches; the rest of the source is unchanged."""
    src = re.sub(r'#include "(\w+\.cuh)"',
                 lambda m: (path.parent / m.group(1)).read_text(), path.read_text())
    src = src.replace("#include <cuda_runtime.h>", f'#include "{EMU_H}"')
    for name in helpers:
        # Each helper runs from its declaration line to the closing brace
        # at the start of a line; with a template line before it if any.
        m = re.search(r"(template <int N>\n)?__device__ __forceinline__ "
                      + re.escape(name) + r".*?\n}\n", src, re.S)
        assert m, f"no {name} in {path.name}"
        src = src[:m.start()] + src[m.end():]
    src = src.replace("extern __shared__ float4 smem4[];", "float4* smem4 = emu_smem;")
    src = re.sub(r"([\w:.]+(?:<[^<>]*>)?)<<<([^>]*)>>>\(", r"emu_launch(\1, \2, ", src)
    return src


def compile_emulated(source, tmp, helpers=ASM_HELPERS):
    cxx = shutil.which("g++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("needs a C++20 host compiler (g++ or clang++)")
    cpp, so = tmp / f"{source.stem}_emu.cpp", tmp / f"lib{source.stem}_emu.so"
    cpp.write_text(host_source(source, helpers))
    subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-w",
                    "-o", str(so), str(cpp)], check=True, timeout=300)
    return _build.bind(ctypes.CDLL(str(so)))


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return compile_emulated(_build.CSRC / "fused.cu", tmp_path_factory.mktemp("fused_emu"))


@pytest.fixture(scope="module")
def dma_lib(tmp_path_factory):
    return compile_emulated(_build.CSRC / "fused_dma.cu", tmp_path_factory.mktemp("dma_emu"))


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


# (m, n, k) for cost_terms' 128 x 128 tiles and 32-deep k slabs: k = 1
# with 4-byte copies, m and n below one tile, k = 21 with ragged m and odd
# n (4-byte copies of V), one slab and a part, several slabs, and a 3 x 2
# grid with a ragged last row of tiles.
COST_SHAPES = [(140, 150, 1), (64, 96, 8), (130, 101, 21), (200, 140, 40),
               (129, 131, 136), (300, 200, 12)]


@pytest.mark.parametrize("mode", ["kl", "is"])
@pytest.mark.parametrize("m,n,k", COST_SHAPES)
def test_emulated_cost_terms_matches_plain_version(lib, mode, m, n, k):
    V, W, H = make(m, n, k, seed=4 + m + k)
    tiles = -(-m // 128) * -(-n // 128)
    assert lib.nmf_cost_partials(m, n) == tiles  # one partial per tile's block
    part = np.full(2 * tiles, np.nan)
    out = np.empty(2, np.float32)
    assert lib.nmf_cost_terms(ptr(V), ptr(W), ptr(H), ptr(part), ptr(out), m, n,
                              k, fk.MODES.index(mode), None) == 0
    want = fk.cost_terms_reference(*(torch.from_numpy(x).double() for x in (V, W, H)), mode)
    want = want if isinstance(want, tuple) else (want,)
    for i, (g, w) in enumerate(zip(out, want)):
        partials = part[i * tiles:(i + 1) * tiles]
        assert np.all(np.isfinite(partials))  # every tile's block wrote its sum
        assert abs(partials.sum() - float(g)) <= 1e-6 * abs(float(g))
        assert abs(float(g) - float(w)) <= REL_TOL * abs(float(w))


# (m, n, k) for the dma kernel, every tier (k <= 128, <= 256, <= 424,
# <= 512) and both sides of each tier edge: k = 1, k % 4 != 0
# (4-byte copies of W), odd n (4-byte copies of V and H), ragged row
# blocks and loop tiles, m and n below one block and one tile, and k = 512.
DMA_SHAPES = [(33, 47, 1), (70, 50, 5), (64, 24, 64), (20, 49, 65), (65, 30, 128),
              (49, 31, 129), (17, 26, 256), (35, 25, 257), (9, 40, 300),
              (50, 13, 424), (33, 17, 425), (40, 23, 512)]


@pytest.mark.parametrize("m,n,k", DMA_SHAPES)
def test_emulated_dma_kernel_matches_plain_version(dma_lib, m, n, k):
    V, W, H = make(m, n, k, seed=m + n + k)
    out = np.full((m, k), np.nan, np.float32)
    assert dma_lib.nmf_kl_phi_dot_ht_dma(ptr(V), ptr(W), ptr(H), ptr(out), m, n, k,
                                         None) == 0
    want = dk.kl_phi_dot_ht_dma_reference(*(torch.from_numpy(x).double() for x in (V, W, H)))
    assert rel(out, want.numpy()) < REL_TOL


def test_emulated_dma_tiers_and_shared_memory(dma_lib):
    """Every k in 1..512 has a tier within an H100 block's shared memory
    (232 448 bytes); k outside that range has none."""
    info = (ctypes.c_int * 4)()
    tiers = []
    for k in range(1, dk.MAX_K + 1):
        assert 0 < dma_lib.nmf_dma_smem_bytes(k) <= 232448
        tiers.append(dma_lib.nmf_dma_tier(k, info))
        assert info[0] * info[2] == 16 * info[1]  # 16 rows per warp of a column group
    assert tiers == sorted(tiers) and set(tiers) == {0, 1, 2, 3}
    edges = (128, 129, 256, 257, 424, 425, 512)
    assert [tiers[k - 1] for k in edges] == [0, 1, 1, 2, 2, 3, 3]
    for k in (0, 513):
        assert dma_lib.nmf_dma_tier(k, info) == -1
        assert dma_lib.nmf_dma_smem_bytes(k) == 0
        assert dma_lib.nmf_kl_phi_dot_ht_dma(None, None, None, None, 4, 4, k, None) != 0
