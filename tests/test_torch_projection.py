"""Port's Hoyer projection (ops/projection.py) and line searches
(ops/linesearch.py) against the JAX package and tests/oracle.py.

The projection gets the same NumPy vectors in both packages, in f64 on
the CPU: values within rtol 1e-12 of the largest entry and the same pass
counts.  Reading "all done" once per group of passes must give the bits
of one read per pass.  The parallel line search must take the sequential
search's decisions: the same factors, cost trace and stepsizes bit for
bit, as tests/test_linesearch_batched.py checks for the JAX package.
"""
import pathlib
import sys

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False

import jax.numpy as jnp  # noqa: E402

import nmf_toolbox_tpu as jt  # noqa: E402
import nmf_toolbox_tpu_torch as tt  # noqa: E402
from nmf_toolbox_tpu.ops import projection as jproj  # noqa: E402
from nmf_toolbox_tpu_torch.ops import linesearch as tls  # noqa: E402
from nmf_toolbox_tpu_torch.ops import projection as tproj  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).parent))
import oracle  # noqa: E402

RTOL = 1e-12
CPU = {"device": "cpu"}  # the port runs arrays on the card unless told


def close(a, b, rtol=RTOL):
    a, b = a.detach().cpu().numpy(), np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * np.max(np.abs(b)))


def columns(seed, N=30, B=17, lo=-0.5):
    return np.random.default_rng(seed).uniform(lo, 1.0, (N, B))


# ---------------------------------------------------------------------------
# The projection against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sparsity", [0.2, 0.6, 0.95])
def test_project_columns_matches_jax(sparsity):
    S = columns(1)
    L1 = tproj.hoyer_l1_target(S.shape[0], sparsity)
    assert L1 == jproj.hoyer_l1_target(S.shape[0], sparsity)
    v, it = tproj.project_columns(torch.from_numpy(S), L1, 1.0)
    vj, itj = jproj.project_columns(jnp.asarray(S), L1, 1.0)
    close(v, vj)
    assert it.dtype == torch.int32
    np.testing.assert_array_equal(it.numpy(), np.asarray(itj))


def test_project_columns_per_column_targets():
    """k1/k2 given per column, as the JAX package allows."""
    S = columns(2, B=6)
    k1 = np.linspace(1.2, 4.0, 6)
    k2 = np.linspace(0.8, 1.5, 6)
    v, it = tproj.project_columns(torch.from_numpy(S), torch.from_numpy(k1),
                                  torch.from_numpy(k2))
    vj, itj = jproj.project_columns(jnp.asarray(S), jnp.asarray(k1), jnp.asarray(k2))
    close(v, vj)
    np.testing.assert_array_equal(it.numpy(), np.asarray(itj))


def test_project_columns_matches_oracle_per_column():
    S = columns(3)
    L1 = tproj.hoyer_l1_target(30, 0.6)
    v, it = tproj.project_columns(torch.from_numpy(S), L1, 1.0)
    for j in range(S.shape[1]):
        vr, itr = oracle.projfunc(S[:, j], L1, 1.0, nn=True)
        np.testing.assert_allclose(v[:, j].numpy(), vr, atol=1e-10)
        assert int(it[j]) == itr


@pytest.mark.parametrize("valid", [19, 29, 30, 40])
def test_project_columns_valid_rows(valid):
    """``valid=``: a padded vector projects as its true part would, and
    the pad stays 0 (the rule for mesh-padded vectors)."""
    S = columns(4, N=30, B=5, lo=0.0)
    L1 = tproj.hoyer_l1_target(min(valid, 30), 0.7)
    v, it = tproj.project_columns(torch.from_numpy(S), L1, 1.0, valid=valid)
    vj, itj = jproj.project_columns(jnp.asarray(S), L1, 1.0, valid=valid)
    close(v, vj)
    np.testing.assert_array_equal(it.numpy(), np.asarray(itj))
    if valid < 30:
        assert not v[valid:].any()
        w, _ = tproj.project_columns(torch.from_numpy(S[:valid]), L1, 1.0)
        close(v[:valid], w.numpy())


@pytest.mark.parametrize("nonneg", [True, False])
def test_projfunc_matches_jax(nonneg):
    s = np.random.default_rng(5).normal(size=(4, 5))
    L1 = tproj.hoyer_l1_target(20, 0.5)
    v, it = tt.projfunc(s, L1, 1.0, nonneg=nonneg, **CPU)
    vj, itj = jt.projfunc(s, L1, 1.0, nonneg=nonneg)
    assert v.shape == (4, 5) and it.ndim == 0
    close(v, vj)
    assert int(it) == int(itj)
    vr, _ = oracle.projfunc(s.reshape(-1), L1, 1.0, nn=nonneg)
    np.testing.assert_allclose(v.numpy().reshape(-1), vr, atol=1e-10)


@pytest.mark.parametrize("N", [2, 3])
def test_projfunc_tiny_vectors(N):
    s = np.random.default_rng(N).uniform(size=N)
    L1 = tproj.hoyer_l1_target(N, 0.5)
    v, it = tt.projfunc(s, L1, 1.0, **CPU)
    vj, itj = jt.projfunc(s, L1, 1.0)
    close(v, vj)
    assert int(it) == int(itj)


def test_projfunc_array_needs_a_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="device"):
        tt.projfunc(np.ones(4), 1.5, 1.0)


@settings(max_examples=30, deadline=None, database=None)
@given(st.integers(4, 60), st.integers(1, 6), st.floats(0.05, 0.95),
       st.integers(0, 2 ** 31 - 1))
def test_projection_satisfies_constraints(N, B, sparsity, seed):
    S = np.random.default_rng(seed).uniform(-0.3, 1.0, (N, B))
    L1 = tproj.hoyer_l1_target(N, sparsity)
    v, it = tproj.project_columns(torch.from_numpy(S), L1, 1.0)
    v = v.numpy()
    assert np.all(v >= 0) and np.all(it.numpy() <= N + 1)
    np.testing.assert_allclose(v.sum(0), L1, rtol=1e-9)
    np.testing.assert_allclose((v ** 2).sum(0), 1.0, rtol=1e-9)


@pytest.mark.parametrize("group", [2, 3, 64])
def test_grouped_passes_bit_identical(group, monkeypatch):
    """A pass over a frozen vector is an exact no-op, so reading "all
    done" once per group of passes gives the bits of one read per pass."""
    S = torch.from_numpy(columns(6, N=50, B=23))
    L1 = tproj.hoyer_l1_target(50, 0.8)
    monkeypatch.setattr(tproj, "PASSES_PER_READ", 1)
    one = tproj.project_columns(S, L1, 1.0)
    monkeypatch.setattr(tproj, "PASSES_PER_READ", group)
    grouped = tproj.project_columns(S, L1, 1.0)
    assert torch.equal(one[0], grouped[0]) and torch.equal(one[1], grouped[1])


def test_projection_reads_once_per_group(monkeypatch):
    from nmf_toolbox_tpu_torch import core
    S = torch.from_numpy(columns(7, N=40, B=8))
    L1 = tproj.hoyer_l1_target(40, 0.9)
    _, it = tproj.project_columns(S, L1, 1.0)
    passes = int(it.max())
    for group in (1, 2, 4):
        monkeypatch.setattr(tproj, "PASSES_PER_READ", group)
        before = core.host_reads
        tproj.project_columns(S, L1, 1.0)
        assert core.host_reads - before == -(-passes // group)


def test_projection_stops_at_n_plus_one_passes(monkeypatch):
    """The JAX rule: at most N + 1 passes, whatever the group size."""
    S = torch.from_numpy(columns(8, N=3, B=4))
    for group in (1, 4, 100):
        monkeypatch.setattr(tproj, "PASSES_PER_READ", group)
        v, it = tproj.project_columns(S, 1.5, 1.0)
        vj, itj = jproj.project_columns(jnp.asarray(S.numpy()), 1.5, 1.0)
        close(v, vj)
        np.testing.assert_array_equal(it.numpy(), np.asarray(itj))
        assert int(it.max()) <= 4


def test_f32_projection_of_a_large_first_trial():
    """A line search's first trial can lie ~1e4 times beyond the target
    scale (nmfsc at 5000x2000 r50: entries ~1e3).  In f32 the
    reference's b^2 - 4ac is rounding noise there; the port's root still
    lands on the sphere, near the f64 projection."""
    S = np.random.default_rng(9).normal(size=(2000, 5)) * 1e3 + 500
    L1 = tproj.hoyer_l1_target(2000, 0.6)
    v32, _ = tproj.project_columns(torch.from_numpy(S.astype(np.float32)), L1, 1.0)
    v64, _ = tproj.project_columns(torch.from_numpy(S), L1, 1.0)
    v32 = v32.double().numpy()
    np.testing.assert_allclose((v32 ** 2).sum(0), 1.0, rtol=1e-4)
    np.testing.assert_allclose(v32, v64.numpy(), atol=1e-4)


# ---------------------------------------------------------------------------
# The line searches
# ---------------------------------------------------------------------------

def test_underflow_threshold():
    assert tls.underflow_threshold(torch.float32) > 0
    assert tls.underflow_threshold(torch.float32) == float(np.finfo(np.float32).tiny)
    assert tls.underflow_threshold(torch.float64) == 1e-200
    assert np.float32(1e-200) == 0  # why the f32 clamp exists


def test_resolve_width():
    assert tls.resolve_width(None) == tls.resolve_width("auto") == 0
    assert tls.resolve_width(0) == 0 and tls.resolve_width(6) == 6
    assert tls.resolve_width("3") == 3


def test_host_steps_round_in_the_factor_dtype():
    """A 1.2x growth of an f32 step rounds as an f32 product, as JAX's
    on-device step does."""
    t = tls.host_scalar_type(torch.float32)
    assert t is np.float32
    s = t(0.7)
    assert t(t(1.2) * s) == np.float32(np.float32(1.2) * np.float32(0.7))


def _problem(m=30, n=40, k=4, seed=0):
    rng = np.random.default_rng(seed)
    V = rng.uniform(0.1, 1.0, (m, n))
    W0 = rng.uniform(size=(m, k))
    H0 = rng.uniform(size=(k, n))
    return V, W0, H0 / np.sqrt((H0 ** 2).sum(1, keepdims=True))


def assert_same_run(a, b):
    assert torch.equal(a.W, b.W) and torch.equal(a.H, b.H)
    np.testing.assert_array_equal(a.cost, b.cost)
    assert (a.n_iters, a.converged) == (b.n_iters, b.converged)
    np.testing.assert_array_equal(np.asarray(a.resume_state["step_w"]),
                                  np.asarray(b.resume_state["step_w"]))
    assert a.resume_state["step_h"] == b.resume_state["step_h"]


@pytest.mark.parametrize("width", [1, 4, 8])
def test_nmfsc_parallel_matches_sequential(width):
    V, W0, H0 = _problem()
    kw = dict(W_sparsity=0.5, H_sparsity=0.6, maxiter=15, tolerance=1e-30,
              dtype=np.float64, **CPU)
    a = tt.nmfsc(V, 4, W_init=W0, H_init=H0, **kw)
    b = tt.nmfsc(V, 4, W_init=W0, H_init=H0, linesearch_width=width, **kw)
    assert_same_run(a, b)


def test_cnmfsc_parallel_matches_sequential():
    V, _, H0 = _problem(seed=2)
    W0 = np.random.default_rng(3).uniform(size=(30, 4, 3))
    kw = dict(W_sparsity=0.4, H_sparsity=0.5, maxiter=10, tolerance=1e-30,
              dtype=np.float64, **CPU)
    a = tt.cnmfsc(V, 4, 3, W_init=W0, H_init=H0, **kw)
    b = tt.cnmfsc(V, 4, 3, W_init=W0, H_init=H0, linesearch_width=6, **kw)
    assert_same_run(a, b)


def test_parallel_underflow_termination_matches():
    """An exact rank-1 fit at high sparsity goes flat: both searches end
    on the same underflow, with the same trimmed trace (JAX's too)."""
    rng = np.random.default_rng(5)
    V = np.outer(rng.uniform(0.5, 1, 12), rng.uniform(0.5, 1, 15))
    W0, H0 = rng.uniform(size=(12, 2)), rng.uniform(size=(2, 15))
    kw = dict(W_sparsity=0.9, H_sparsity=0.9, tolerance=0.0, dtype=np.float64,
              maxiter=400)
    a = tt.nmfsc(V, 2, W_init=W0, H_init=H0, **kw, **CPU)
    b = tt.nmfsc(V, 2, W_init=W0, H_init=H0, linesearch_width=8, **kw, **CPU)
    j = jt.nmfsc(V, 2, W_init=W0, H_init=H0, **kw)
    assert a.converged and b.converged and a.n_iters < 400
    assert_same_run(a, b)
    assert (a.n_iters, len(a.cost)) == (j.n_iters, len(j.cost))
    np.testing.assert_allclose(a.cost, np.asarray(j.cost), rtol=1e-9, atol=0)


def test_search_tie_rules():
    """Decisions of one round of the parallel search on a scalar
    objective: the first acceptable step wins; an underflow strictly
    before it pre-empts it."""
    X, dX = torch.zeros(1, dtype=torch.float64), torch.ones(1, dtype=torch.float64)
    ident = lambda x: x  # noqa: E731

    def obj(accept_below):  # accept candidates whose step is < accept_below
        return lambda Xc: -Xc.reshape(Xc.shape[:-1] if Xc.ndim > 1 else ()) - accept_below

    for width in (1, 3, 8):
        seq = tls.backtracking_search(obj(0.3), X, dX, 1.0, ident, torch.tensor(0.0, dtype=torch.float64))
        par = tls.parallel_backtracking_search(obj(0.3), X, dX, 1.0, ident,
                                               torch.tensor(0.0, dtype=torch.float64), width)
        assert seq[1] == par[1] and seq[2] == par[2] and torch.equal(seq[0], par[0])
        assert float(seq[0]) == -0.25 and seq[1] == np.float64(1.2 * 0.25)
    # never acceptable: both halve down to the threshold and report underflow
    seq = tls.backtracking_search(obj(-1.0), X, dX, 1.0, ident, torch.tensor(0.0, dtype=torch.float64))
    par = tls.parallel_backtracking_search(obj(-1.0), X, dX, 1.0, ident,
                                           torch.tensor(0.0, dtype=torch.float64), 8)
    assert seq[2] and par[2] and seq[1] == par[1] < 1e-200
    assert torch.equal(seq[0], X) and torch.equal(par[0], X)
