"""The naive KL passes' CUDA source (csrc/naive_kl.cu), run on the CPU.

As tests/test_torch_fused_emulated.py does for the fused kernels, the
source is compiled with the host C++ compiler against
``tests/cuda_emu.h``, here with ``-ffp-contract=off`` so that the host
rounds every step as the card's ``__f*_rn`` intrinsics do, and called
through the library's own C interface.  Each case holds the field
``torch.equal`` to its plain version (``ops/kernels/naive_kl``'s
``kl_field_reference``) and the cost within 1e-6 relative of an f64 sum
of the plain version's f32 terms.  The build takes blocks of 64 threads
(two warps), so that a few hundred entries fill several blocks and the
largest shape runs the grid-stride loop past one wave (132 SMs x 3
blocks emulated).
The cases: a 1x1 input, n not a multiple of 4, m x n not a multiple of
a block, weighted and unweighted (the field takes weights: without them
it returns an error and writes nothing), 16-byte aligned pointers
(float4 loads and a scalar tail) and pointers 4 bytes off (scalar loads
throughout), and zero weights where V is 0 or NaN (the M > 0 gate must
zero them).
This checks the kernels' indexing, tails, gate and reductions; the
``cuda`` tests of tests/test_torch_naive_kl.py check the card's
rounding.  Imports no JAX.
"""
import ctypes
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

sys.path.insert(0, str(pathlib.Path(__file__).parent))
from test_torch_fused_emulated import compile_emulated  # noqa: E402

from nmf_toolbox_tpu_torch.ops.kernels import _build  # noqa: E402
from nmf_toolbox_tpu_torch.ops.kernels import naive_kl as nk  # noqa: E402

THREADS = 64     # the emulated build's blocks: two warps
WAVE = 132 * 3   # emulated SMs x the emulated occupancy
COST_RTOL = 1e-6
# (m, n): one entry, n odd (m n = 15), ragged blocks and a float4 tail,
# whole float4s, and more entries than one wave's threads take in float4s.
SHAPES = [(1, 1), (3, 5), (37, 51), (64, 64), (400, 263)]
assert 400 * 263 > WAVE * THREADS * 4


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return compile_emulated(_build.CSRC / "naive_kl.cu",
                            tmp_path_factory.mktemp("naive_kl_emu"), helpers=(),
                            prelude=f"#define NMF_NAIVE_KL_THREADS {THREADS}\n",
                            flags=("-ffp-contract=off",))


def place(a, aligned):
    """A copy of ``a`` (f32) at a 16-byte aligned address, or 4 bytes past one."""
    buf = np.zeros(a.size + 8, np.float32)
    at = (-buf.ctypes.data % 16) // 4 + (0 if aligned else 1)
    out = buf[at:at + a.size].reshape(a.shape)
    out[...] = a
    assert (out.ctypes.data % 16 == 0) == aligned
    return out


def ptr(a):
    return None if a is None else a.ctypes.data_as(ctypes.c_void_p)


def make(m, n, weighted, seed):
    """V, V_hat in (0.05, 2); with weights, M in {0} u (0, 1], some zero
    weights over V = 0 and V = NaN (entries whose terms are NaN)."""
    rng = np.random.default_rng(seed)
    V = rng.uniform(0.05, 2, (m, n)).astype(np.float32)
    Vh = rng.uniform(0.05, 2, (m, n)).astype(np.float32)
    if not weighted:
        return V, Vh, None
    M = np.where(rng.uniform(size=(m, n)) < 0.3, 0, rng.uniform(0.1, 1, (m, n)))
    M = M.astype(np.float32)
    M.flat[0] = 0
    V.flat[0] = np.nan
    if V.size > 2:
        M.flat[-1] = 0
        V.flat[-1] = 0
    return V, Vh, M


def f64_cost(V, Vh, M):
    """The f64 sum of the plain version's f32 terms."""
    V, Vh = torch.from_numpy(V), torch.from_numpy(Vh)
    t = V * torch.log(V / Vh) - V + Vh
    if M is not None:
        M = torch.from_numpy(M)
        t = torch.where(M > 0, M * t, torch.zeros((), dtype=t.dtype))
    return float(torch.sum(t.double()))


@pytest.mark.parametrize("aligned", [True, False], ids=["float4", "scalar"])
@pytest.mark.parametrize("weighted", [True, False], ids=["weighted", "unweighted"])
@pytest.mark.parametrize("m,n", SHAPES)
def test_emulated_kl_passes_match_plain_version(lib, m, n, weighted, aligned):
    V, Vh, M = (None if x is None else place(x, aligned)
                for x in make(m, n, weighted, seed=m * n + weighted))
    N = m * n
    phi = place(np.full((m, n), np.nan, np.float32), aligned)
    if weighted:
        assert lib.nmf_kl_field(ptr(V), ptr(Vh), ptr(M), ptr(phi), N, None) == 0
        want = nk.kl_field_reference(torch.from_numpy(V), torch.from_numpy(Vh),
                                     torch.from_numpy(M))
        assert torch.equal(torch.from_numpy(phi), want)
    else:  # the field takes weights (unweighted it is V / V_hat, a torch pass)
        assert lib.nmf_kl_field(ptr(V), ptr(Vh), None, ptr(phi), N, None) != 0
        assert np.isnan(phi).all()

    blocks = lib.nmf_kl_cost_partials(N, int(weighted))
    assert blocks == min(-(-(-(-N // 4)) // THREADS), WAVE)
    part = np.full(blocks, np.nan)
    out = np.full(1, np.nan, np.float32)
    assert lib.nmf_kl_cost(ptr(V), ptr(Vh), ptr(M), ptr(part), ptr(out), N, None) == 0
    assert np.all(np.isfinite(part))  # every block wrote its partial
    want = f64_cost(V, Vh, M)
    assert np.isfinite(out[0])
    assert abs(float(out[0]) - want) <= COST_RTOL * abs(want)
    again = np.full(1, np.nan, np.float32)
    assert lib.nmf_kl_cost(ptr(V), ptr(Vh), ptr(M), ptr(part), ptr(again), N, None) == 0
    assert again[0] == out[0]  # a fixed order: the same bits
