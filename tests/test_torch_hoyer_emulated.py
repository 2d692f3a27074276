"""The Hoyer projection kernel (csrc/hoyer.cu), run on the CPU.

As tests/test_torch_fused_emulated.py does for the fused kernels, the
source is compiled with the host C++ compiler against
``tests/cuda_emu.h`` (threads, block barriers, ``__shfl_xor_sync``, and
thread-block clusters: a cluster's CTAs run together, with distributed
shared memory and a cluster barrier) and called through the library's
own C interface, then held against the plain version
(``ops/kernels/hoyer.hoyer_project_reference``): the same done flags, the
same pass counts, v within 1e-12 (f64) or 1e-5 (f32) of the largest
entry, and identical bits over two runs.  (On the card, the ``cuda``
tests allow f32 pass counts within one: the sums' order there may move
a pass.)

The CPU builds define a small tier table (32 or 64 threads, 2-4 entries
a thread, clusters of 2 and 4), so that vectors of a few hundred entries
reach every tier: one CTA, a cluster, and the streaming tier past the
last.  The inputs have rows done in their first pass, rows done after
several, rows the pass budget leaves undone, padded rows (``valid``),
per-vector targets, rows at batch strides (a slice of wider rows,
swapped batch axes) and batched leading axes; the kernel takes
contiguous entries (the wrapper copies W's columns, rows of W.mT, so
first).  A build with clusters of up to 16 CTAs checks the opt-in past
8 on each emulated card.  This checks the kernel's
indexing, reductions and control flow, not the card's rounding: the
``cuda`` tests do that on the card.  Imports no JAX.
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

# The CPU builds' tier table: X(threads, entries per thread, CTAs at most).
SMALL_TIERS = {
    np.float32: ((32, 2, 1), (64, 3, 1), (32, 4, 4)),
    np.float64: ((32, 2, 1), (64, 2, 1), (32, 3, 4)),
}
STREAM_THREADS = 64
# (N, tier, CTAs a vector): every tier, clusters of 2, 3 and 4 CTAs, the
# streaming tier last.
TIER_N = {np.float32: ((40, 0, 1), (150, 1, 1), (230, 2, 2), (300, 2, 3), (500, 2, 4),
                       (777, 3, 1)),
          np.float64: ((40, 0, 1), (100, 1, 1), (170, 2, 2), (250, 2, 3), (380, 2, 4),
                       (777, 3, 1))}
CASES = range(6)


def table(tiers):
    return " ".join(f"X({t}, {i}, {c})" for t, i, c in tiers)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    # hoyer.cu has no asm helpers to swap
    prelude = (f"#define NMF_HOYER_TIERS_F32(X) {table(SMALL_TIERS[np.float32])}\n"
               f"#define NMF_HOYER_TIERS_F64(X) {table(SMALL_TIERS[np.float64])}\n"
               f"#define NMF_HOYER_STREAM_THREADS {STREAM_THREADS}\n")
    return compile_emulated(_build.CSRC / "hoyer.cu", tmp_path_factory.mktemp("hoyer_emu"),
                            helpers=(), prelude=prelude)


def ptr(a):
    return None if a is None else a.ctypes.data_as(ctypes.c_void_p)


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


def target(k, batch, dtype):
    """(array or None, stride, value) of k1 or k2 as the wrapper passes them."""
    if np.ndim(k) == 0:
        return None, 0, float(k)
    return np.ascontiguousarray(np.broadcast_to(k, batch), dtype=dtype).reshape(-1), 1, 0.0


def run_kernel(lib, S, k1, k2, passes, valid=None):
    """The kernel on S (at most 3 axes, contiguous entries, any batch
    strides) through the C interface, v in S's layout."""
    N = S.shape[-1]
    batch = S.shape[:-1]
    v = np.full_like(S, np.nan)  # order "K": S's layout, dense
    done = np.full(batch, 7, np.uint8)
    iters = np.full(batch, -1, np.int32)
    item = S.itemsize
    assert S.strides[-1] == item and v.strides[-1] == item
    s0, s1 = ((0,) * (3 - S.ndim) + tuple(s // item for s in S.strides))[:2]
    v0, v1 = ((0,) * (3 - v.ndim) + tuple(s // item for s in v.strides))[:2]
    t1, st1, c1 = target(k1, batch, S.dtype)
    t2, st2, c2 = target(k2, batch, S.dtype)
    err = lib.nmf_hoyer_project(
        ptr(S), ptr(v), ptr(done), ptr(iters), math.prod(batch),
        S.shape[-2] if S.ndim >= 2 else 1, N, N if valid is None else valid,
        s0, s1, v0, v1, ptr(t1), st1, c1, ptr(t2), st2, c2,
        min(passes, N + 1), int(S.dtype == np.float64), None)
    assert err == 0
    return v, done.astype(bool), iters


def check(lib, S, k1, k2, passes, valid=None):
    v, done, iters = run_kernel(lib, S, k1, k2, passes, valid)
    as_t = (lambda k: k if np.ndim(k) == 0 else torch.from_numpy(np.asarray(k, S.dtype)))
    want_v, want_done, want_iters = hk.hoyer_project_reference(
        torch.from_numpy(S), as_t(k1), as_t(k2), passes, valid)
    np.testing.assert_array_equal(done, want_done.numpy())
    np.testing.assert_array_equal(iters, want_iters.numpy())
    w = want_v.numpy()
    assert np.max(np.abs(v - w)) <= V_TOL[S.dtype.type] * np.max(np.abs(w))
    if valid is not None:
        assert not v[..., valid:].any()  # the pad stays zero
    v2, done2, iters2 = run_kernel(lib, S, k1, k2, passes, valid)
    assert np.array_equal(v, v2, equal_nan=True) and np.array_equal(done, done2)
    assert np.array_equal(iters, iters2)
    return done, iters, v


def tier_of(lib, N, dtype):
    info = (ctypes.c_int * 3)()
    return lib.nmf_hoyer_tier(N, int(dtype == np.float64), info), tuple(info)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("t", CASES)
def test_emulated_kernel_matches_plain_version(lib, dtype, t):
    """Every tier: one CTA, clusters of 2, 3 and 4 CTAs, and the streaming
    tier, with batched leading axes."""
    N, index, ranks = TIER_N[dtype][t]
    got = tier_of(lib, N, dtype)
    assert got[0] == index and got[1][2] == ranks
    batch = ((6,), (5,), (2, 3), (3, 2), (4,), (3,))[t]
    S = rows(batch, N, seed=N, dtype=dtype)
    done, iters, _ = check(lib, S, hoyer_l1_target(N, 0.6 + 0.05 * t), 1.0, 48)
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
    done, iters, _ = check(lib, S, k1, 1.0, 3)
    assert sorted(iters[done]) == [1, 2]
    assert (~done).any() and (iters[~done] == 3).all()
    done, iters, _ = check(lib, S, k1, 1.0, 0)
    assert not done.any() and not iters.any()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("t", CASES)
def test_emulated_kernel_valid(lib, dtype, t):
    """Padded vectors: the entries past `valid` start zeroed and stay 0,
    and the sums divide by `valid`, in every tier (`valid` past the CTA
    or cluster rank that holds the first pad)."""
    N = TIER_N[dtype][t][0]
    valid = N - max(1, N // 7)
    S = rows((4,), N, seed=10 + N, dtype=dtype)
    S[..., valid:] = 5.0  # whatever the pad holds is ignored
    done, _, _ = check(lib, S, hoyer_l1_target(valid, 0.6), 1.0, 48, valid=valid)
    assert done.all()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("t", [0, 3, 5])
def test_emulated_kernel_per_vector_targets(lib, dtype, t):
    """k1 and k2 per vector (an array over a batch of 2 x 3) and k1 per
    vector broadcast from one axis (shape (2, 1)) with a scalar k2."""
    N = TIER_N[dtype][t][0]
    S = rows((2, 3), N, seed=20 + N, dtype=dtype)
    rng = np.random.default_rng(N)
    sp = rng.uniform(0.3, 0.8, (2, 3))
    k2 = rng.uniform(0.5, 2.0, (2, 3))
    k1 = np.array([[hoyer_l1_target(N, x) for x in r] for r in sp]) * np.sqrt(k2)
    done, _, _ = check(lib, S, k1, k2, 48)
    assert done.all()
    k1 = np.array([[hoyer_l1_target(N, 0.4)], [hoyer_l1_target(N, 0.7)]])
    done, _, _ = check(lib, S, k1, 1.0, 48)
    assert done.all()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("t", [1, 4, 5])
def test_emulated_kernel_strided_rows(lib, dtype, t):
    """Rows at batch strides, read and written in place: the first N
    columns of wider rows, and a (2, 3) batch with its axes swapped
    (strides (N, 2 N)), v in that layout."""
    N = TIER_N[dtype][t][0]
    S = rows((5,), N + 13, seed=30 + N, dtype=dtype)[:, :N]
    assert S.strides == ((N + 13) * S.itemsize, S.itemsize)
    done, _, _ = check(lib, S, hoyer_l1_target(N, 0.6), 1.0, 48)
    assert done.all()
    S = np.swapaxes(rows((3, 2), N, seed=31 + N, dtype=dtype), 0, 1)  # (2, 3, N)
    done, _, v = check(lib, S, hoyer_l1_target(N, 0.6), 1.0, 48)
    assert done.all() and np.swapaxes(v, 0, 1).flags.c_contiguous  # S's own layout


def test_emulated_kernel_long_vectors(lib):
    """N past the last cluster tier: the streaming tier, both dtypes."""
    for dtype in (np.float64, np.float32):
        N = 1501
        assert tier_of(lib, N, dtype) == (len(SMALL_TIERS[dtype]), (STREAM_THREADS, 0, 1))
        S = rows((3,), N, seed=5, dtype=dtype)
        done, _, _ = check(lib, S, hoyer_l1_target(N, 0.6), 1.0, 48)
        assert done.all()


def test_emulated_kernel_one_vector(lib):
    """A lone vector (no batch axes), as projfunc gives it."""
    S = rows((1,), 230, seed=2, dtype=np.float64)[0]
    done, iters, _ = check(lib, S, hoyer_l1_target(230, 0.7), 1.0, 231)
    assert done.shape == () and bool(done) and iters > 1


@pytest.mark.parametrize("N", [230, 777])
def test_emulated_kernel_negative_zero_entries(lib, N):
    """-0.0 in S is an entry like any other (the kernel marks zeroed
    entries as -0.0 inside), in a cluster tier and the streaming tier."""
    S = rows((3,), N, seed=6, dtype=np.float64)
    S[:, ::5] = -0.0
    done, _, v = check(lib, S, hoyer_l1_target(N, 0.6), 1.0, 48)
    assert done.all() and not np.signbit(v[v == 0]).any()


def test_emulated_kernel_nan_passes_through(lib):
    """A NaN entry makes its vector NaN and never done, as in _pass; the
    other vectors are untouched by it."""
    S = rows((3,), 230, seed=4, dtype=np.float64)
    S[1, 7] = np.nan
    v, done, iters = run_kernel(lib, S, hoyer_l1_target(230, 0.6), 1.0, 10)
    assert done[0] and done[2] and not done[1] and iters[1] == 10
    assert np.isnan(v[1]).all() and np.isfinite(v[[0, 2]]).all()


def test_emulated_tier_table(lib, tmp_path_factory):
    """The table chooses the smallest tier that holds N, a cluster tier as
    many CTAs as N needs, and the streaming tier past the last; the
    built-in table gives H's 2000 entries one CTA, W's 100 000 a cluster
    (7 CTAs in f32, 13 in f64) and a million entries the streaming tier,
    within a CTA's 1024 threads, 128 entries a thread and 16 CTAs a
    cluster."""
    for dtype, tiers in SMALL_TIERS.items():
        caps = [t * i * c for t, i, c in tiers]
        for N in range(1, caps[-1] + 80):
            index, info = tier_of(lib, N, dtype)
            if N > caps[-1]:
                assert index == len(tiers) and info == (STREAM_THREADS, 0, 1)
            else:
                t, i, c = tiers[index]
                assert caps[index] >= N and (index == 0 or caps[index - 1] < N)
                assert info == (t, i, -(-N // (t * i)))
        assert tier_of(lib, 0, dtype)[0] == -1
    full = compile_emulated(_build.CSRC / "hoyer.cu", tmp_path_factory.mktemp("hoyer_table"),
                            helpers=())
    for dtype in (np.float32, np.float64):
        for N in (1, 2000, 10_000, 100_000, 262_144, 1_000_000):
            index, (threads, items, ranks) = tier_of(full, N, dtype)
            assert threads % 32 == 0 and threads <= 1024 and items <= 128 and ranks <= 16
            assert items == 0 or threads * items * ranks >= N
        assert tier_of(full, 2000, dtype)[1][2] == 1
        assert tier_of(full, 100_000, dtype)[1][2] == (7 if dtype == np.float32 else 13)
        assert tier_of(full, 1_000_000, dtype)[1][1] == 0


def test_emulated_cluster_opt_in_on_every_card(tmp_path_factory):
    """A cluster of more than 8 CTAs launches only where its kernel has
    the non-portable opt-in, an attribute on each card: the kernel asks
    for it on every card it launches on, so a projection on a second card
    after one on the first launches too.  A build whose one register tier
    is 32 threads x 1 entry x up to 16 CTAs gives 300 entries 10 CTAs."""
    prelude = ("#define NMF_HOYER_TIERS_F32(X) X(32, 1, 16)\n"
               "#define NMF_HOYER_TIERS_F64(X) X(32, 1, 16)\n"
               f"#define NMF_HOYER_STREAM_THREADS {STREAM_THREADS}\n")
    wide = compile_emulated(_build.CSRC / "hoyer.cu", tmp_path_factory.mktemp("hoyer_16"),
                            helpers=(), prelude=prelude)
    N = 300
    for dtype in (np.float64, np.float32):
        assert tier_of(wide, N, dtype) == (0, (32, 1, 10))
        S = rows((2,), N, seed=40, dtype=dtype)
        for card in (0, 1, 0, 2):
            wide.emu_set_device(card)
            done, _, _ = check(wide, S, hoyer_l1_target(N, 0.6), 1.0, 48)
            assert done.all()


def test_emulated_kernel_refuses_bad_sizes(lib):
    base = dict(B=1, B1=1, N=4, valid=4, passes=1)

    def call(**kw):
        a = {**base, **kw}
        return lib.nmf_hoyer_project(None, None, None, None, a["B"], a["B1"], a["N"],
                                     a["valid"], 0, 0, 0, 0, None, 0, 1.0, None, 0, 1.0,
                                     a["passes"], 1, None)

    for bad in (dict(B=0), dict(N=0), dict(valid=0), dict(valid=5), dict(passes=-1),
                dict(B=3, B1=2)):
        assert call(**bad) != 0, bad


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def card_cases():
    """(batch, N, sparseness, transposed): every tier of the built-in table
    in f32 (f64's lie at the same edges or inside them), with W's columns
    given as a strided view."""
    return [((6,), 40, 0.6, False), ((5,), 2000, 0.6, False), ((2, 3), 7777, 0.5, False),
            ((3,), 10_000, 0.6, False), ((2,), 30_000, 0.5, True), ((2,), 60_000, 0.5, True),
            ((3,), 100_000, 0.5, True), ((2,), 200_000, 0.5, True), ((2,), 300_000, 0.5, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("batch,N,sp,transposed", card_cases())
def test_kernel_matches_plain_version_on_card(cuda, dtype, batch, N, sp, transposed):
    """On the card: the kernel against the plain version there, the same
    done flags, pass counts within one in f32 (the sums' order), and
    identical bits over two launches."""
    S = torch.from_numpy(rows(batch, N, seed=N, dtype=np.float64)).to(cuda, dtype)
    if transposed:
        S = S.mT.contiguous().mT
    k1 = hoyer_l1_target(N, sp)
    before = hk.hoyer_project_launches
    v, done, iters = hk.hoyer_project(S, k1, 1.0, 48)
    torch.cuda.synchronize()
    assert hk.hoyer_project_launches == before + 1
    assert v.shape == S.shape and (transposed or v.stride() == S.stride())
    want_v, want_done, want_iters = hk.hoyer_project_reference(S, k1, 1.0, 48)
    assert torch.equal(done, want_done)
    slack = 0 if dtype == torch.float64 else 1
    assert int((iters - want_iters).abs().max()) <= slack
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    assert float((v - want_v).abs().max()) <= tol * float(want_v.abs().max())
    v2, done2, iters2 = hk.hoyer_project(S, k1, 1.0, 48)
    assert torch.equal(v, v2) and torch.equal(done, done2) and torch.equal(iters, iters2)


@pytest.mark.cuda
def test_kernel_on_a_second_card(cuda):
    """W's 100 000-entry columns in f64 take a cluster of 13 CTAs, which
    needs the non-portable opt-in on each card: the kernel on card 0, then
    card 1, then card 0 again, against the plain version."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    N = 100_000
    assert hk.tier(N, torch.float64)[3] == 13
    k1 = hoyer_l1_target(N, 0.5)
    S = torch.from_numpy(rows((3,), N, seed=7, dtype=np.float64))
    for index in (0, 1, 0):
        Sd = S.to(torch.device("cuda", index))
        v, done, iters = hk.hoyer_project(Sd, k1, 1.0, 48)
        want_v, want_done, want_iters = hk.hoyer_project_reference(Sd, k1, 1.0, 48)
        assert v.device == Sd.device
        assert torch.equal(done, want_done) and bool(done.all())
        assert torch.equal(iters, want_iters)
        assert float((v - want_v).abs().max()) <= 1e-12 * float(want_v.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_valid_and_per_vector_targets_on_card(cuda, dtype):
    N = 100_000
    S = torch.from_numpy(rows((4,), N, seed=1, dtype=np.float64)).to(cuda, dtype)
    k1 = torch.tensor([hoyer_l1_target(N - 999, x) for x in (0.3, 0.5, 0.6, 0.8)],
                      dtype=dtype, device=cuda)
    v, done, iters = hk.hoyer_project(S, k1, 1.0, 64, valid=N - 999)
    want_v, want_done, want_iters = hk.hoyer_project_reference(S, k1, 1.0, 64, valid=N - 999)
    assert torch.equal(done, want_done) and bool(done.all())
    assert int((iters - want_iters).abs().max()) <= (0 if dtype == torch.float64 else 1)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    assert float((v - want_v).abs().max()) <= tol * float(want_v.abs().max())
    assert not bool(v[:, N - 999:].any())
