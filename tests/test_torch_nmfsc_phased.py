"""The port's phased nmfsc dispatch (``models/nmfsc_phased.py``) and its
bounded Hoyer projection, on the CPU.

``nmfsc(..., dispatch="phased")`` must equal the port's default nmfsc bit
for bit in f64 (W, H, cost, n_iters, converged, resume_state) in every
case of tests/test_nmfsc_phased.py and tests/test_fuzz_phased.py, and
the JAX package's phased dispatch within test_torch_sparse.py's rtol
1e-9 with the same n_iters and converged.  It raises where JAX's does,
reads the host once per block of ``spec_ahead`` iterations, and
``project_rows_bounded`` equals ``project_rows`` bit for bit when its
budget covers the passes and JAX's ``_project_columns_bounded`` within
1e-12.  Inputs come from NumPy seeds; each package gets the same arrays.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False

import nmf_toolbox_tpu as jt  # noqa: E402
import nmf_toolbox_tpu_torch as tt  # noqa: E402
from nmf_toolbox_tpu.models.nmfsc_phased import _project_columns_bounded  # noqa: E402
from nmf_toolbox_tpu_torch import core  # noqa: E402
from nmf_toolbox_tpu_torch.ops.projection import (hoyer_l1_target, project_rows,  # noqa: E402
                                                  project_rows_bounded)

RTOL = 1e-9
CPU = {"device": "cpu"}
F64 = dict(tolerance=1e-30, dtype=np.float64)


def problem(m=30, n=40, k=4, seed=0):
    """tests/test_nmfsc_phased.py's problem."""
    rng = np.random.default_rng(seed)
    V = rng.uniform(0.1, 1.0, (m, n))
    W0 = rng.uniform(size=(m, k))
    H0 = rng.uniform(size=(k, n))
    return V, W0, H0 / np.sqrt((H0 ** 2).sum(1, keepdims=True))


def assert_same(b, a):
    """Every field of two port results, bit for bit."""
    assert torch.equal(b.W, a.W) and torch.equal(b.H, a.H)
    assert b.cost.dtype == a.cost.dtype
    np.testing.assert_array_equal(b.cost, a.cost)
    assert (b.n_iters, b.converged) == (a.n_iters, a.converged)
    assert b.resume_state == a.resume_state


def assert_close_to_jax(t, j):
    for x, y in ((t.W, j.W), (t.H, j.H)):
        y = np.asarray(y)
        np.testing.assert_allclose(x.numpy(), y, rtol=RTOL, atol=RTOL * np.max(np.abs(y)))
    assert len(t.cost) == len(j.cost)
    np.testing.assert_allclose(t.cost, np.asarray(j.cost), rtol=RTOL, atol=0)
    assert (t.n_iters, t.converged) == (j.n_iters, j.converged)
    for key in ("step_w", "step_h"):
        np.testing.assert_allclose(t.resume_state[key], j.resume_state[key], rtol=1e-12)


def both(V, k, **kw):
    """(default, phased) port results on the same call."""
    a = tt.nmfsc(V, k, **kw, **CPU)
    return a, tt.nmfsc(V, k, dispatch="phased", **kw, **CPU)


@functools.lru_cache(maxsize=None)
def jax_phased(seed, items):
    V, W0, H0 = problem(seed=seed)
    return jt.nmfsc(V, 4, W_init=W0, H_init=H0, dispatch="phased", **dict(items))


CONFIGS = [
    dict(W_sparsity=0.5, H_sparsity=0.6),
    dict(W_sparsity=0.5),          # sparse W + MU H (renorm transfer)
    dict(H_sparsity=0.6),          # MU W + sparse H
    dict(W_sparsity=0.8, H_sparsity=0.3, W_fixed=True),
]


@pytest.mark.parametrize("kw", CONFIGS, ids=lambda kw: "-".join(kw))
def test_phased_bit_identical_to_default(kw):
    V, W0, H0 = problem()
    a, b = both(V, 4, W_init=W0, H_init=H0, maxiter=15, **F64, **kw)
    assert_same(b, a)


@pytest.mark.parametrize("kw", CONFIGS, ids=lambda kw: "-".join(kw))
def test_phased_matches_jax_phased(kw):
    V, W0, H0 = problem()
    b = tt.nmfsc(V, 4, W_init=W0, H_init=H0, maxiter=15, dispatch="phased", **F64, **kw,
                 **CPU)
    assert_close_to_jax(b, jax_phased(0, tuple(dict(maxiter=15, **F64, **kw).items())))


def test_phased_tolerance_stop():
    V, W0, H0 = problem(seed=3)
    kw = dict(W_sparsity=0.4, H_sparsity=0.5, tolerance=1e-4, dtype=np.float64, maxiter=100)
    a, b = both(V, 4, W_init=W0, H_init=H0, **kw)
    assert_same(b, a)
    assert b.converged and b.n_iters < 100
    assert_close_to_jax(b, jax_phased(3, tuple(kw.items())))


def test_phased_underflow_termination():
    """A rank-1 exact fit at high sparsity ends on a W line-search
    underflow (at tolerance 1e-30: 0 falls back to 1e-3, which stops it
    first): the iteration's cost is dropped, as the default does."""
    rng = np.random.default_rng(5)
    V = np.outer(rng.uniform(0.5, 1, 12), rng.uniform(0.5, 1, 15))
    W0 = rng.uniform(size=(12, 2))
    H0 = rng.uniform(size=(2, 15))
    kw = dict(W_sparsity=0.9, H_sparsity=0.9, tolerance=1e-30, dtype=np.float64, maxiter=400)
    a, b = both(V, 2, W_init=W0, H_init=H0, **kw)
    assert_same(b, a)
    assert b.converged and len(b.cost) == b.n_iters


def test_phased_resume_round_trip():
    V, W0, H0 = problem(seed=7)
    kw = dict(W_sparsity=0.5, H_sparsity=0.5, **F64, **CPU)
    ref = tt.nmfsc(V, 4, W_init=W0, H_init=H0, maxiter=12, **kw)
    a = tt.nmfsc(V, 4, W_init=W0, H_init=H0, maxiter=5, dispatch="phased", **kw)
    b = tt.nmfsc(V, 4, W_init=a.W, H_init=a.H, maxiter=7, resume_state=a.resume_state,
                 dispatch="phased", **kw)
    assert torch.equal(b.W, ref.W) and torch.equal(b.H, ref.H)
    np.testing.assert_array_equal(b.cost, ref.cost[5:])
    assert b.resume_state == ref.resume_state


@pytest.mark.parametrize("extra", [dict(trials=2), dict(fuse_iteration=False),
                                   dict(trials=3, fuse_iteration=False)],
                         ids=["trials2", "unfused", "trials3-unfused"])
def test_phased_slow_path_variants(extra):
    """trials=2 sends many searches to the host redo; fuse_iteration=False
    runs the per-phase path every iteration."""
    V, W0, H0 = problem(seed=11)
    kw = dict(W_init=W0, H_init=H0, W_sparsity=0.6, H_sparsity=0.6, maxiter=12, **F64)
    a = tt.nmfsc(V, 4, **kw, **CPU)
    assert_same(tt.nmfsc(V, 4, dispatch="phased", **extra, **kw, **CPU), a)


@pytest.mark.parametrize("seed", range(8))
def test_phased_fuzz_bit_identical(seed):
    """tests/test_fuzz_phased.py's draws, spec_ahead 1-5 included."""
    rng = np.random.default_rng(1000 + seed)
    m = int(rng.integers(10, 48))
    n = int(rng.integers(12, 56))
    k = int(rng.integers(2, 6))
    V = rng.uniform(0.05, 1.0, (m, n))
    W0 = rng.uniform(size=(m, k))
    H0 = rng.uniform(size=(k, n))
    H0 = H0 / np.sqrt((H0 ** 2).sum(1, keepdims=True))
    kw = dict(maxiter=int(rng.integers(3, 14)),
              tolerance=float(rng.choice([1e-30, 1e-4, 1e-2])), dtype=np.float64)
    which = rng.integers(0, 3)
    if which in (0, 2):
        kw["W_sparsity"] = float(rng.uniform(0.1, 0.85))
    if which in (1, 2):
        kw["H_sparsity"] = float(rng.uniform(0.1, 0.85))
    if rng.uniform() < 0.25:
        kw["W_fixed" if which == 1 else "H_fixed"] = True
    a = tt.nmfsc(V, k, W_init=W0, H_init=H0, **kw, **CPU)
    b = tt.nmfsc(V, k, W_init=W0, H_init=H0, dispatch="phased",
                 spec_ahead=int(rng.integers(1, 6)), **kw, **CPU)
    assert_same(b, a)


def test_phased_batched_trials():
    """Batched rounds close to sequential trials; linesearch_width=8 is
    batched_trials=True with trials=8, and equals the default solver at
    width 8, bit for bit."""
    V, W0, H0 = problem(seed=13)
    kw = dict(W_init=W0, H_init=H0, W_sparsity=0.5, H_sparsity=0.6, maxiter=12, **F64,
              **CPU)
    a = tt.nmfsc(V, 4, dispatch="phased", **kw)
    b = tt.nmfsc(V, 4, dispatch="phased", batched_trials=True, **kw)
    np.testing.assert_allclose(b.W.numpy(), a.W.numpy(), atol=1e-10)
    np.testing.assert_allclose(b.cost, a.cost, rtol=1e-10)
    c = tt.nmfsc(V, 4, dispatch="phased", batched_trials=True, trials=8, **kw)
    d = tt.nmfsc(V, 4, dispatch="phased", linesearch_width=8, **kw)
    assert_same(d, c)
    assert_same(d, tt.nmfsc(V, 4, linesearch_width=8, **kw))


def test_phased_f32_trace_dtype():
    V, W0, H0 = problem()
    kw = dict(W_init=W0, H_init=H0, maxiter=4, H_sparsity=0.5, dtype=np.float32, **CPU)
    b = tt.nmfsc(V, 4, dispatch="phased", **kw)
    assert b.cost.dtype == np.float32 and len(b.cost) == 5
    assert b.W.dtype == torch.float32
    assert_same(b, tt.nmfsc(V, 4, **kw))


def test_phased_refuses_a_mesh():
    """Both packages refuse mesh= with the phased dispatch; the port does
    before it looks at the mesh, so any stand-in shows it."""
    V, W0, H0 = problem()
    kw = dict(W_init=W0, H_init=H0, maxiter=2, dispatch="phased", H_sparsity=0.5)
    with pytest.raises(ValueError, match="single-device"):
        tt.nmfsc(V, 4, mesh=object(), **kw, **CPU)
    from nmf_toolbox_tpu.parallel import make_mesh
    with pytest.raises(ValueError, match="single-device"):
        jt.nmfsc(V, 4, mesh=make_mesh(1), **kw)


def test_phased_too_few_passes_raises():
    """proj_passes=1 cannot finish the initial projections: RuntimeError
    in both packages."""
    V, W0, H0 = problem()
    kw = dict(W_init=W0, H_init=H0, maxiter=3, dispatch="phased", H_sparsity=0.6,
              proj_passes=1, dtype=np.float64)
    with pytest.raises(RuntimeError, match="proj_passes"):
        tt.nmfsc(V, 4, **kw, **CPU)
    with pytest.raises(RuntimeError, match="proj_passes"):
        jt.nmfsc(V, 4, **kw)


def test_unknown_dispatch_raises():
    V, W0, H0 = problem()
    with pytest.raises(ValueError, match="unknown dispatch"):
        tt.nmfsc(V, 4, W_init=W0, H_init=H0, maxiter=2, dispatch="Phased", **CPU)


def test_phased_host_reads():
    """12 iterations in blocks of 4 with no slow-path redo: one read as
    V comes in (its range), one for the initial cost and projections, one
    per block and one for the final stepsizes, 3 + 12 / 4 in all.  The
    default reads every trial."""
    V, W0, H0 = problem(seed=2)
    kw = dict(W_init=W0, H_init=H0, H_sparsity=0.6, maxiter=12, **F64, **CPU)
    r0 = core.host_reads
    a = tt.nmfsc(V, 4, **kw)
    r1 = core.host_reads
    b = tt.nmfsc(V, 4, dispatch="phased", spec_ahead=4, **kw)
    r2 = core.host_reads
    assert_same(b, a)
    assert b.n_iters == 12
    assert r2 - r1 == 1 + 1 + 12 // 4 + 1 == 3 + 12 // 4
    assert r1 - r0 > 12


PROJ_CASES = [((4,), 40, 0.6), ((3, 5), 97, 0.8), ((2, 3, 2), 300, 0.4)]


def proj_input(batch, N, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(*batch, N)) + rng.uniform(0, 1, (*batch, 1))


@pytest.mark.parametrize("batch,N,sp", PROJ_CASES)
def test_bounded_projection_equals_project_rows(batch, N, sp):
    """Rows, batched rows, and the columns of a factor as W.mT views."""
    S = torch.from_numpy(proj_input(batch, N, seed=N))
    k1 = hoyer_l1_target(N, sp)
    v, iters = project_rows(S, k1, 1.0)
    b, done = project_rows_bounded(S, k1, 1.0, int(iters.max()))
    assert torch.equal(b, v) and bool(done.all())
    W = S.reshape(-1, N).T
    v, _ = project_rows(W.mT, k1, 1.0)
    b, done = project_rows_bounded(W.mT, k1, 1.0, 48)
    assert torch.equal(b, v) and bool(done.all())


@pytest.mark.parametrize("passes", [48, 3, 1])
@pytest.mark.parametrize("batch,N,sp", PROJ_CASES)
def test_bounded_projection_matches_jax(batch, N, sp, passes):
    """Within 1e-12 of JAX's bounded projection when both finish (JAX
    keeps the reference's b^2 - 4ac root, the port its cancellation-free
    one), and the same done flags with too few passes."""
    S = proj_input(batch, N, seed=N + 1).reshape(-1, N)
    k1 = hoyer_l1_target(N, sp)
    v, done = project_rows_bounded(torch.from_numpy(S), k1, 1.0, passes)
    jv, jdone = _project_columns_bounded(S.T, k1, 1.0, passes)
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
    if passes == 48:
        assert bool(done.all())
        np.testing.assert_allclose(v.numpy(), np.asarray(jv).T, rtol=0,
                                   atol=1e-12 * np.max(np.abs(np.asarray(jv))))
