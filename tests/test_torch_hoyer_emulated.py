"""The bounded Hoyer projection kernel (csrc/hoyer.cu), run on the CPU.

As tests/test_torch_fused_emulated.py does for the fused kernels, the
source is compiled with the host C++ compiler against
``tests/cuda_emu.h`` (threads, block barriers, ``__shfl_xor_sync``) and
called through the library's own C interface, then held against the
plain version (``ops/kernels/hoyer.hoyer_project_reference``): the same
done flags and pass counts, v within 1e-12 (f64) or 1e-5 of the largest
entry (f32), and identical bits over two runs.  The inputs have rows
done in their first pass, rows done after several, rows the pass budget
leaves undone, N below, at and above a block's threads, batched leading
axes, and the 1024-thread variant for long vectors.  This checks the
kernel's indexing, reductions and control flow, not the card's rounding:
the ``cuda`` test does that on the card.  Imports no JAX.
"""
import ctypes
import math
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

sys.path.insert(0, str(pathlib.Path(__file__).parent))
from test_torch_fused_emulated import compile_emulated  # noqa: E402

from nmf_toolbox_tpu_torch.ops.kernels import _build  # noqa: E402
from nmf_toolbox_tpu_torch.ops.kernels import hoyer as hk  # noqa: E402
from nmf_toolbox_tpu_torch.ops.projection import hoyer_l1_target  # noqa: E402

V_TOL = {np.float64: 1e-12, np.float32: 1e-5}  # of the largest entry


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    # hoyer.cu has no asm helpers to swap
    return compile_emulated(_build.CSRC / "hoyer.cu", tmp_path_factory.mktemp("hoyer_emu"),
                            helpers=())


def ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def rows(batch, N, seed, dtype):
    """Rows of three kinds, cycling: dense positive ones, mixed-sign ones
    (both take several passes) and spiky ones, a few large entries over
    noise, which a mild sparsity finishes in one or two passes."""
    rng = np.random.default_rng(seed)
    B = math.prod(batch)
    S = np.empty((B, N))
    for b in range(B):
        kind = b % 3
        if kind == 0:
            S[b] = rng.uniform(0.5, 1.0, N)
        elif kind == 1:
            S[b] = rng.normal(size=N)
        else:
            S[b] = 0.05 * rng.normal(size=N)
            S[b, rng.choice(N, max(1, N // 20), replace=False)] += rng.uniform(1, 3)
    return np.ascontiguousarray(S.reshape(*batch, N).astype(dtype))


def run_kernel(lib, S, k1, k2, passes):
    N = S.shape[-1]
    B = math.prod(S.shape[:-1])
    v = np.full(S.shape, np.nan, S.dtype)
    zero = np.empty(S.shape, np.uint8)
    done = np.full(S.shape[:-1], 7, np.uint8)
    iters = np.full(S.shape[:-1], -1, np.int32)
    err = lib.nmf_hoyer_project(ptr(S), ptr(v), ptr(zero), ptr(done), ptr(iters), B, N,
                                min(passes, N + 1), k1, k2, int(S.dtype == np.float64), None)
    assert err == 0
    return v, done.astype(bool), iters


def check(lib, S, k1, k2, passes):
    v, done, iters = run_kernel(lib, S, k1, k2, passes)
    want_v, want_done, want_iters = hk.hoyer_project_reference(
        torch.from_numpy(S), k1, k2, passes)
    np.testing.assert_array_equal(done, want_done.numpy())
    np.testing.assert_array_equal(iters, want_iters.numpy())
    w = want_v.numpy()
    assert np.max(np.abs(v - w)) <= V_TOL[S.dtype.type] * np.max(np.abs(w))
    v2, done2, iters2 = run_kernel(lib, S, k1, k2, passes)
    assert np.array_equal(v, v2) and np.array_equal(done, done2)
    assert np.array_equal(iters, iters2)
    return done, iters


# (batch, N, sparseness): N below one block's 256 threads, above and
# ragged, a batch of candidates as a batched trial round projects them.
CASES = [((6,), 40, 0.6), ((5,), 300, 0.8), ((2, 3), 777, 0.5), ((2, 1, 3), 97, 0.9)]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("batch,N,sp", CASES)
def test_emulated_kernel_matches_plain_version(lib, dtype, batch, N, sp):
    S = rows(batch, N, seed=N, dtype=dtype)
    done, iters = check(lib, S, hoyer_l1_target(N, sp), 1.0, 48)
    assert done.all()
    assert iters.min() >= 1 and iters.max() > 1  # done in the first pass and later


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_emulated_kernel_pass_budget(lib, dtype):
    """A budget of 3 passes finishes the spiky rows, one in its first pass
    and one in its second, and leaves the others undone after all 3; a
    budget of 0 returns the hyperplane projection."""
    N = 300
    S = rows((6,), N, seed=3, dtype=dtype)
    k1 = hoyer_l1_target(N, 0.5)
    done, iters = check(lib, S, k1, 1.0, 3)
    assert sorted(iters[done]) == [1, 2]
    assert (~done).any() and (iters[~done] == 3).all()
    done, iters = check(lib, S, k1, 1.0, 0)
    assert not done.any() and not iters.any()


def test_emulated_kernel_long_vectors(lib):
    """N past the 1024-thread threshold."""
    N = 16411
    assert lib.nmf_hoyer_threads(N) == 1024 and lib.nmf_hoyer_threads(N - 100) == 256
    S = rows((2,), N, seed=5, dtype=np.float64)
    done, _ = check(lib, S, hoyer_l1_target(N, 0.6), 1.0, 48)
    assert done.all()


def test_emulated_kernel_refuses_bad_sizes(lib):
    assert lib.nmf_hoyer_project(None, None, None, None, None, 0, 4, 1, 1.0, 1.0, 1, None) != 0
    assert lib.nmf_hoyer_project(None, None, None, None, None, 1, 0, 1, 1.0, 1.0, 1, None) != 0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("batch,N,sp", CASES + [((2,), 16411, 0.6)])
def test_kernel_matches_plain_version_on_card(cuda, dtype, batch, N, sp):
    """On the card: the kernel against the plain version there, the same
    done flags, pass counts within one in f32 (the sums' order), and
    identical bits over two launches."""
    S = torch.from_numpy(rows(batch, N, seed=N, dtype=np.float64)).to(cuda, dtype)
    k1 = hoyer_l1_target(N, sp)
    before = hk.hoyer_project_launches
    v, done, iters = hk.hoyer_project(S, k1, 1.0, 48)
    torch.cuda.synchronize()
    assert hk.hoyer_project_launches == before + 1
    want_v, want_done, want_iters = hk.hoyer_project_reference(S, k1, 1.0, 48)
    assert torch.equal(done, want_done)
    slack = 0 if dtype == torch.float64 else 1
    assert int((iters - want_iters).abs().max()) <= slack
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    assert float((v - want_v).abs().max()) <= tol * float(want_v.abs().max())
    v2, done2, iters2 = hk.hoyer_project(S, k1, 1.0, 48)
    assert torch.equal(v, v2) and torch.equal(done, done2) and torch.equal(iters, iters2)
