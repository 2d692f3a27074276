"""Port's projected-gradient solvers (``nmfsc``, ``cnmfsc``) against the
JAX package, tests/oracle.py and the stored goldens.

Both packages get the same NumPy inputs and injected inits and run in f64
on the CPU: cost traces within rtol 1e-9 with equal lengths, factors
within rtol 1e-9 of their largest entry, ``n_iters``, ``converged`` and
the line-search stepsizes equal.  The parameter sets are those of
tests/test_sparse_solvers.py.  Each JAX result is computed once (the
nested while loops are slow to compile on the CPU).
"""
import functools
import importlib
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False

import nmf_toolbox_tpu as jt  # noqa: E402
import nmf_toolbox_tpu_torch as tt  # noqa: E402
from nmf_toolbox_tpu_torch import core  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).parent))
import oracle  # noqa: E402

GOLD = pathlib.Path(__file__).parent / "goldens"
RTOL = 1e-9
CPU = {"device": "cpu"}  # the port runs arrays on the card unless told
F64 = dict(tolerance=1e-12, dtype=np.float64)


def close(a, b, rtol=RTOL):
    a = a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * np.max(np.abs(b)))


def assert_parity(t, j):
    assert torch.is_tensor(t.W) and t.W.device.type == "cpu"
    close(t.W, j.W)
    close(t.H, j.H)
    assert isinstance(t.cost, np.ndarray) and len(t.cost) == len(j.cost)
    np.testing.assert_allclose(t.cost, np.asarray(j.cost), rtol=RTOL, atol=0)
    assert (t.n_iters, t.converged) == (j.n_iters, j.converged)
    np.testing.assert_allclose(t.resume_state["step_w"], j.resume_state["step_w"], rtol=1e-12)
    np.testing.assert_allclose(t.resume_state["step_h"], j.resume_state["step_h"], rtol=1e-12)


def nmfsc_problem(seed=0, m=24, n=36, k=4):
    rng = np.random.default_rng(seed)
    V = rng.uniform(0.05, 1.0, (m, n))
    W0 = rng.uniform(size=(m, k))
    H0 = rng.uniform(size=(k, n))
    return V, W0, H0 / np.sqrt((H0 ** 2).sum(1, keepdims=True))


def cnmfsc_problem(T=3, seed=0, m=16, n=40, k=3):
    rng = np.random.default_rng(seed)
    V = rng.uniform(0.05, 1, (m, n))
    W0 = rng.uniform(0.1, 1, (m, k, T))
    H0 = rng.uniform(size=(k, n))
    return V, W0, H0 / np.sqrt((H0 ** 2).sum(1, keepdims=True))


@functools.lru_cache(maxsize=None)
def jax_nmfsc(seed, maxiter, items):
    V, W0, H0 = nmfsc_problem(seed)
    return jt.nmfsc(V, 4, W_init=W0, H_init=H0, maxiter=maxiter, **F64, **dict(items))


@functools.lru_cache(maxsize=None)
def jax_cnmfsc(T, seed, maxiter, items):
    V, W0, H0 = cnmfsc_problem(T, seed)
    return jt.cnmfsc(V, 3, T, W_init=W0, H_init=H0, maxiter=maxiter, **F64, **dict(items))


NMFSC_CASES = [
    {},                                       # plain MU + row renorm
    {"H_sparsity": 0.6},                      # H line search
    {"W_sparsity": 0.5},                      # W line search
    {"W_sparsity": 0.5, "H_sparsity": 0.6},   # both
    {"W_fixed": True, "H_sparsity": 0.6},
    {"H_fixed": True, "W_sparsity": 0.5},
]


@pytest.mark.parametrize("kw", NMFSC_CASES, ids=lambda kw: "-".join(kw) or "mu")
def test_nmfsc_matches_jax(kw):
    V, W0, H0 = nmfsc_problem()
    t = tt.nmfsc(V, 4, W_init=W0, H_init=H0, maxiter=20, **F64, **kw, **CPU)
    assert_parity(t, jax_nmfsc(0, 20, tuple(kw.items())))
    Wg, Hg, cg = oracle.nmfsc(V, W0, H0, maxiter=20, tolerance=1e-12, **kw)
    np.testing.assert_allclose(t.cost, cg, rtol=RTOL)


CNMFSC_CASES = [
    (3, {}), (3, {"H_sparsity": 0.6}), (3, {"W_sparsity": 0.5}),
    (3, {"W_sparsity": 0.5, "H_sparsity": 0.6}),
    (1, {"W_sparsity": 0.4}),                 # T = 1, ends on an underflow
    (3, {"W_fixed": True, "H_sparsity": 0.6}),
    (3, {"H_fixed": True, "W_sparsity": 0.5}),
]


@pytest.mark.parametrize("T,kw", CNMFSC_CASES,
                         ids=lambda x: x if isinstance(x, int) else "-".join(x) or "mu")
def test_cnmfsc_matches_jax(T, kw):
    V, W0, H0 = cnmfsc_problem(T)
    t = tt.cnmfsc(V, 3, T, W_init=W0, H_init=H0, maxiter=15, **F64, **kw, **CPU)
    assert_parity(t, jax_cnmfsc(T, 0, 15, tuple(kw.items())))
    assert t.resume_state["step_w"].shape == (T,)
    _, _, cg = oracle.cnmfsc(V, W0, H0, T, maxiter=15, tolerance=1e-12, **kw)
    np.testing.assert_allclose(t.cost, cg, rtol=RTOL)


def test_cnmfsc_underflow_trims_like_jax():
    """T = 1 with a sparse W ends on a W line-search underflow: the trace
    drops the terminated iteration's cost, as JAX's does
    (cnmfsc.m:245-249)."""
    V, W0, H0 = cnmfsc_problem(1)
    t = tt.cnmfsc(V, 3, 1, W_init=W0, H_init=H0, maxiter=15, W_sparsity=0.4, **F64, **CPU)
    j = jax_cnmfsc(1, 0, 15, (("W_sparsity", 0.4),))
    assert t.converged and t.n_iters < 15
    assert len(t.cost) == len(j.cost) == t.n_iters


@pytest.mark.parametrize("name", ["nmfsc_sparse", "cnmfsc_sparse"])
def test_golden(name):
    g = np.load(GOLD / f"{name}.npz")
    if name == "nmfsc_sparse":
        r = tt.nmfsc(g["V"], g["W0"].shape[1], W_init=g["W0"], H_init=g["H0"],
                     W_sparsity=0.5, H_sparsity=0.6, maxiter=12, **F64, **CPU)
    else:
        r = tt.cnmfsc(g["V"], g["W0"].shape[1], int(g["T"]), W_init=g["W0"],
                      H_init=g["H0"], W_sparsity=float(g["W_sparsity"]),
                      H_sparsity=float(g["H_sparsity"]), maxiter=10, **F64, **CPU)
        np.testing.assert_allclose(r.H.numpy(), g["H"], atol=1e-9)
    assert len(r.cost) == len(g["cost"])
    np.testing.assert_allclose(r.W.numpy(), g["W"], atol=1e-9)
    np.testing.assert_allclose(r.cost, g["cost"], rtol=1e-9)


@pytest.mark.parametrize("solver", ["nmfsc", "cnmfsc"])
def test_resume_continues_bit_for_bit(solver):
    """12 iterations, then 12 more from the returned factors and
    resume_state, equal 24 at once.  (cnmfsc with a sparse W ends on an
    underflow in its first iteration at these shapes, as the reference
    does: tests/goldens/cnmfsc_sparse.npz holds one cost.)"""
    kw = dict(H_sparsity=0.6, tolerance=1e-30, dtype=np.float64, **CPU)
    if solver == "nmfsc":
        V, W0, H0 = nmfsc_problem(1)
        run = lambda **c: tt.nmfsc(V, 4, W_sparsity=0.5, **c, **kw)  # noqa: E731
    else:
        V, W0, H0 = cnmfsc_problem(3)
        run = lambda **c: tt.cnmfsc(V, 3, 3, **c, **kw)  # noqa: E731
    whole = run(W_init=W0, H_init=H0, maxiter=24)
    first = run(W_init=W0, H_init=H0, maxiter=12)
    rest = run(W_init=first.W, H_init=first.H, maxiter=12,
               resume_state=first.resume_state)
    assert whole.n_iters == 24 and rest.n_iters == 12
    assert torch.equal(rest.W, whole.W) and torch.equal(rest.H, whole.H)
    np.testing.assert_array_equal(rest.cost, whole.cost[12:])
    np.testing.assert_array_equal(np.asarray(rest.resume_state["step_w"]),
                                  np.asarray(whole.resume_state["step_w"]))


def test_cnmfsc_resume_state_shape_checked():
    V, W0, H0 = cnmfsc_problem(3)
    with pytest.raises(ValueError, match="step_w"):
        tt.cnmfsc(V, 3, 3, W_init=W0, H_init=H0, maxiter=2, **CPU,
                  resume_state={"step_w": np.ones(2), "step_h": 1.0})


@pytest.mark.parametrize("dispatch", [None, "fused", "phased"])
def test_dispatch_runs_the_one_solver(dispatch):
    """Every dispatch equals the JAX package's phased dispatch (itself
    bit-identical to its fused solver); "phased" runs the port's phased
    dispatch with the keys it honours (3 trials a round, blocks of 2
    iterations), which the other dispatches ignore."""
    V, W0, H0 = nmfsc_problem(2)
    kw = dict(W_sparsity=0.5, H_sparsity=0.6, maxiter=15, tolerance=1e-30, dtype=np.float64)
    t = tt.nmfsc(V, 4, W_init=W0, H_init=H0, dispatch=dispatch, trials=3, spec_ahead=2,
                 **kw, **CPU)
    j = _jax_phased(2)
    assert_parity(t, j)


@functools.lru_cache(maxsize=None)
def _jax_phased(seed):
    V, W0, H0 = nmfsc_problem(seed)
    return jt.nmfsc(V, 4, W_init=W0, H_init=H0, dispatch="phased", W_sparsity=0.5,
                    H_sparsity=0.6, maxiter=15, tolerance=1e-30, dtype=np.float64)


def test_unknown_dispatch_raises():
    V, W0, H0 = nmfsc_problem()
    with pytest.raises(ValueError, match="unknown dispatch"):
        tt.nmfsc(V, 4, dispatch="relay", **CPU)


@pytest.mark.parametrize("solver", ["nmfsc", "cnmfsc"])
def test_negative_v_raises(solver):
    V, W0, H0 = nmfsc_problem()
    V[0, 0] = -1.0
    with pytest.raises(ValueError, match="Negative values"):
        if solver == "nmfsc":
            tt.nmfsc(V, 4, **CPU)
        else:
            tt.cnmfsc(V, 2, 2, **CPU)


def test_mesh_raises():
    """mesh= is ported (tests/test_torch_parallel_solvers.py); a mesh
    that is not a parallel.make_mesh one raises TypeError."""
    V, _, _ = nmfsc_problem()
    with pytest.raises(TypeError, match="make_mesh"):
        tt.nmfsc(V, 4, mesh=object(), **CPU)


def test_initial_cost_and_sparseness():
    """cost[0] is the initial cost of the rescaled V (nmfsc.m:137-139);
    with both factors sparse, W's columns keep unit L2 and the Hoyer L1
    target (nmfsc.m:93-96)."""
    from nmf_toolbox_tpu_torch.ops.projection import hoyer_l1_target
    V, W0, H0 = nmfsc_problem(3)
    r = tt.nmfsc(V, 4, W_init=W0, H_init=H0, maxiter=5, dtype=np.float64, **CPU)
    c0 = 0.5 * np.sum((V / V.max() - W0 @ H0) ** 2)
    np.testing.assert_allclose(r.cost[0], c0, rtol=1e-12)
    assert len(r.cost) == 6
    r = tt.nmfsc(V, 4, W_init=W0, H_init=H0, W_sparsity=0.7, H_sparsity=0.5,
                 maxiter=10, dtype=np.float64, **CPU)
    W = r.W.numpy()
    np.testing.assert_allclose((W ** 2).sum(0), 1.0, atol=1e-8)
    np.testing.assert_allclose(W.sum(0), hoyer_l1_target(24, 0.7), atol=1e-8)


def test_default_inits_are_seeded():
    V, _, _ = nmfsc_problem()
    a = tt.nmfsc(V, 4, H_sparsity=0.5, maxiter=5, seed=3, **CPU)
    b = tt.nmfsc(V, 4, H_sparsity=0.5, maxiter=5, seed=3, **CPU)
    assert torch.equal(a.W, b.W) and a.W.dtype == torch.float64
    c = tt.cnmfsc(V, 2, 3, H_sparsity=0.5, maxiter=3, seed=3, dtype=np.float32, **CPU)
    assert c.W.shape == (24, 2, 3) and c.W.dtype == torch.float32
    assert np.all(np.isfinite(c.cost))


@pytest.mark.parametrize("solver", ["nmfsc", "cnmfsc"])
def test_tf32_settings_forced_off_and_restored(solver, monkeypatch):
    """Inside the solve every f32 matmul backend is at full precision;
    the caller's TF32 choice comes back on return and on an exception."""
    mm = torch.backends.cuda.matmul
    seen = []
    real = core.host_read

    def spy(t):
        seen.append(mm.fp32_precision)
        return real(t)
    saved = mm.fp32_precision
    try:
        mm.fp32_precision = "tf32"
        V, W0, H0 = cnmfsc_problem(2) if solver == "cnmfsc" else nmfsc_problem()
        for mod in ("linesearch", "projection", "loop"):
            monkeypatch.setattr(f"nmf_toolbox_tpu_torch.ops.{mod}.host_read", spy)
        call = (lambda **c: tt.cnmfsc(V, 3, 2, W_init=W0, H_init=H0, **c)) \
            if solver == "cnmfsc" else (lambda **c: tt.nmfsc(V, 4, W_init=W0, H_init=H0, **c))
        call(H_sparsity=0.5, maxiter=3, dtype=np.float32, **CPU)
        assert seen and set(seen) == {"ieee"}
        assert mm.fp32_precision == "tf32"
        with pytest.raises(TypeError, match="make_mesh"):  # a foreign mesh
            call(maxiter=3, mesh=object(), **CPU)
        monkeypatch.setattr(importlib.import_module(f"nmf_toolbox_tpu_torch.models.{solver}"),
                            "project_rows", _raise)  # the initial projection, inside the solve
        with pytest.raises(RuntimeError, match="inside"):
            call(H_sparsity=0.5, maxiter=3, **CPU)
        assert mm.fp32_precision == "tf32"
    finally:
        mm.fp32_precision = saved


def _raise(*args):
    raise RuntimeError("raised inside the solve")


def test_host_reads_per_iteration():
    """The reads of an iteration are its trials, its projection groups
    and the stop rule: counted, and bounded by the trials' count."""
    V, W0, H0 = nmfsc_problem(4)
    before = core.host_reads
    r = tt.nmfsc(V, 4, W_init=W0, H_init=H0, W_sparsity=0.5, H_sparsity=0.6,
                 maxiter=10, tolerance=1e-30, **CPU)
    reads = core.host_reads - before
    # ingest (1) + two initial projections (>= 1 each) + per iteration at
    # least one trial and one projection group per search, and the stop
    # rule from the second iteration on
    assert reads >= 2 + r.n_iters * 5
    assert reads < 3 + r.n_iters * 200
