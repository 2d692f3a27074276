"""Port's Gram/MU family (lnmf, seminmf, convexnmf, chnmf) and its inits
(kmeans, kmeans_indicator_h, convex_hull_anchors) against the JAX package.

Both sides get the same NumPy inputs and injected inits (the packages'
seeded default inits draw different numbers) and run in f64 on the CPU:
factors and cost traces agree to rtol 1e-9, with n_iters and converged
equal; the stored goldens hold at tests/test_goldens.py's tolerances.
One small shape per solver keeps the JAX side to few compiles.
"""
import importlib
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False

import jax  # noqa: E402

import nmf_toolbox_tpu as jt  # noqa: E402
import nmf_toolbox_tpu_torch as tt  # noqa: E402
from nmf_toolbox_tpu.utils import init as ji  # noqa: E402
from nmf_toolbox_tpu_torch.interop import factors_from_numpy  # noqa: E402
from nmf_toolbox_tpu_torch.ops import loop as looplib  # noqa: E402
from nmf_toolbox_tpu_torch.ops.gram import pos_neg_split  # noqa: E402
from nmf_toolbox_tpu_torch.utils import init as ti  # noqa: E402

tcvx = importlib.import_module("nmf_toolbox_tpu_torch.models.convexnmf")
GOLD = pathlib.Path(__file__).parent / "goldens"
RTOL = 1e-9  # f64 factors (of their largest entry) and cost traces
CPU = {"device": "cpu"}  # the port runs arrays on the card unless told
M, N, K = 14, 24, 3


def np_(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def assert_parity(t, j, fields):
    for name in fields:
        a, b = getattr(t, name), np.asarray(getattr(j, name))
        assert torch.is_tensor(a) and a.device.type == "cpu", name
        np.testing.assert_allclose(np_(a), b, rtol=RTOL,
                                   atol=RTOL * np.max(np.abs(b)), err_msg=name)
    assert isinstance(t.cost, np.ndarray) and t.cost.shape == np.shape(j.cost)
    np.testing.assert_allclose(t.cost, np.asarray(j.cost), rtol=RTOL, atol=0)
    assert (t.n_iters, t.converged) == (j.n_iters, j.converged)


def data(seed=0, signed=False):
    rng = np.random.default_rng(seed)
    V = rng.normal(size=(M, N)) if signed else rng.uniform(0.1, 1.0, (M, N))
    return (V, rng.uniform(size=(M, K)), rng.uniform(size=(K, N)) + 0.2,
            rng.uniform(size=(N, K)))


# ---------------------------------------------------------------------------
# Cross-package parity in f64, every branch of each solver
# ---------------------------------------------------------------------------

# (solver, signed V, config); the runs named for their stop rule are
# checked to stop by it.
CASES = {
    "lnmf": ("lnmf", False, {}),
    "lnmf_w_fixed": ("lnmf", False, {"W_fixed": True}),
    "lnmf_h_fixed": ("lnmf", False, {"H_fixed": True}),
    "lnmf_stops_inclusive": ("lnmf", False, {"tolerance": 0.05}),
    "lnmf_cost_every_inclusive": ("lnmf", False, {"cost_every": 4, "tolerance": 0.05}),
    "seminmf": ("seminmf", True, {}),
    "seminmf_w_fixed": ("seminmf", True, {"W_fixed": True}),
    "seminmf_h_fixed": ("seminmf", True, {"H_fixed": True}),
    "seminmf_stops": ("seminmf", True, {"tolerance": 0.1}),
    "convexnmf_nonneg": ("convexnmf", False, {}),
    "convexnmf_general": ("convexnmf", True, {}),
    "convexnmf_sparsity": ("convexnmf", True, {"G_sparsity": 0.2}),
    "convexnmf_g_fixed": ("convexnmf", False, {"G_fixed": True}),
    "convexnmf_h_fixed": ("convexnmf", True, {"H_fixed": True}),
    "convexnmf_compat": ("convexnmf", False, {"compat": "reference"}),
    "chnmf": ("chnmf", False, {}),
    "chnmf_signed": ("chnmf", True, {"G_sparsity": 0.1, "H_sparsity": 0.2}),
    "chnmf_g_fixed": ("chnmf", False, {"G_fixed": True}),
    "chnmf_h_fixed": ("chnmf", False, {"H_fixed": True}),
    "chnmf_compat_p_equals_k": ("chnmf", False, {"compat": "reference"}),
}
FIELDS = {"lnmf": "WH", "seminmf": "WH", "convexnmf": ("W", "H", "G"),
          "chnmf": ("W", "H", "S", "G")}


def inits(solver, V, W0, H0, G0):
    if solver in ("lnmf", "seminmf"):
        return {"W_init": W0, "H_init": H0}
    if solver == "convexnmf":
        return {"G_init": G0, "H_init": H0}
    S = V[:, [1, 5, 9]]  # p == k, so compat="reference" runs too
    return {"S_init": S, "G_init": G0[:3], "H_init": H0}


@pytest.mark.parametrize("case", sorted(CASES))
def test_parity_with_jax(case):
    solver, signed, cfg = CASES[case]
    V, W0, H0, G0 = data(1, signed)
    kw = {"maxiter": 25, "tolerance": 1e-12, **inits(solver, V, W0, H0, G0), **cfg}
    j = getattr(jt, solver)(V, K, dtype=np.float64, **kw)
    t = getattr(tt, solver)(V, K, **kw, **CPU)
    assert_parity(t, j, FIELDS[solver])
    if "stops" in case or "inclusive" in case:
        assert j.converged


def test_lnmf_trace_untrimmed_and_cadence_bit_identical():
    """lnmf keeps its trace at maxiter, zero after the stop (lnmf.m:89-91),
    and cost_every leaves the factors bit-identical."""
    V, W0, H0, _ = data(2)
    kw = dict(W_init=W0, H_init=H0, maxiter=30, tolerance=1e-12, **CPU)
    r1, r4 = tt.lnmf(V, K, **kw), tt.lnmf(V, K, cost_every=4, **kw)
    assert torch.equal(r1.W, r4.W) and torch.equal(r1.H, r4.H)
    s = tt.lnmf(V, K, **{**kw, "tolerance": 0.05})
    assert s.converged and len(s.cost) == 30 and np.all(s.cost[s.n_iters:] == 0)


def test_convexnmf_nonneg_step_matches_general_step():
    """The 3-product step of a non-negative V and the pos/neg-split step
    are one algorithm: both on the same non-negative problem."""
    V, _, H0, G0 = (torch.from_numpy(x) for x in data(3))
    VtV = V.T @ V
    runs = []
    for grams in ((VtV,), pos_neg_split(VtV)):
        step = tcvx._make_step(grams, torch.trace(VtV), 0.0, False, False)
        runs.append(looplib.run(step, (G0, H0), 20, 1e-30, cost_dtype=V.dtype))
    for x, y in zip(runs[0].state + (runs[0].cost_buf,), runs[1].state + (runs[1].cost_buf,)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-10)


def test_chnmf_compat_differs_from_paper():
    V, _, H0, G0 = data(4)
    kw = dict(S_init=V[:, :3], G_init=G0[:3], H_init=H0, maxiter=15, **CPU)
    a = tt.chnmf(V, K, compat="reference", **kw)
    b = tt.chnmf(V, K, **kw)
    assert not torch.allclose(a.H, b.H)


# ---------------------------------------------------------------------------
# Goldens (tests/test_goldens.py's tolerances)
# ---------------------------------------------------------------------------

GOLDENS = {
    "lnmf": (("W", "H"), lambda g: tt.lnmf(
        g["V"], g["W0"].shape[1], W_init=g["W0"], H_init=g["H0"], maxiter=15,
        tolerance=1e-12, dtype=np.float64, **CPU)),
    "seminmf": (("W", "H"), lambda g: tt.seminmf(
        g["V"], g["W0"].shape[1], W_init=g["W0"], H_init=g["H0"], maxiter=15,
        tolerance=1e-12, dtype=np.float64, **CPU)),
    "convexnmf": (("W", "H", "G"), lambda g: tt.convexnmf(
        g["V"], g["G0"].shape[1], G_init=g["G0"], H_init=g["H0"], maxiter=15,
        tolerance=1e-12, dtype=np.float64, **CPU)),
    "chnmf": (("W", "H"), lambda g: tt.chnmf(
        g["V"], g["G0"].shape[1], S_init=g["S"], G_init=g["G0"], H_init=g["H0"],
        maxiter=15, tolerance=1e-12, dtype=np.float64, **CPU)),
}


@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_golden(name):
    g = np.load(GOLD / f"{name}.npz")
    fields, run = GOLDENS[name]
    r = run(g)
    for f in fields:
        np.testing.assert_allclose(np_(getattr(r, f)), g[f], atol=1e-9, err_msg=f)
    np.testing.assert_allclose(r.cost, g["cost"], rtol=1e-9)


# ---------------------------------------------------------------------------
# The inits
# ---------------------------------------------------------------------------

def planted(seed, k=4, per=25, d=6):
    """Points round k far-apart centers, shuffled, and their clusters."""
    rng = np.random.default_rng(seed)
    centers = 20.0 * rng.normal(size=(k, d))
    X = np.concatenate([c + rng.normal(size=(per, d)) for c in centers])
    order = rng.permutation(len(X))
    return X[order], np.repeat(np.arange(k), per)[order]


def same_partition(a, b):
    """Equal up to the labels' order: a bijection between the labels."""
    pairs = set(zip(a.tolist(), b.tolist()))
    return len(pairs) == len(set(a.tolist())) == len(set(b.tolist()))


# (JAX's seed 2 ends in a local optimum on planted(2), so it is not used.)
@pytest.mark.parametrize("seed", [0, 1, 3])
def test_kmeans_same_partition_as_jax(seed):
    X, truth = planted(seed)
    lj, _ = ji.kmeans(jax.random.PRNGKey(seed), X, 4)
    lt, ct = ti.kmeans(torch.Generator().manual_seed(seed), X, 4, **CPU)
    assert lt.shape == (len(X),) and ct.shape == (4, X.shape[1])
    assert same_partition(np.asarray(lj), lt.numpy())
    assert same_partition(truth, lt.numpy())


def test_kmeans_indicator_h_same_clusters_as_jax():
    V = planted(3)[0].T  # columns are the points
    hj = np.asarray(ji.kmeans_indicator_h(jax.random.PRNGKey(0), V, 4, np.float64))
    ht = ti.kmeans_indicator_h(torch.Generator().manual_seed(0), V, 4, **CPU)
    assert ht.dtype == torch.float64 and ht.shape == (4, V.shape[1])
    assert set(np.unique(ht.numpy())) == {0.2, 1.2}
    assert same_partition(np.argmax(hj, axis=0), torch.argmax(ht, dim=0).numpy())


@pytest.mark.parametrize("shape", [(9, 60), (30, 200)])
def test_convex_hull_anchors_match_jax_exact_path(shape):
    V = np.random.default_rng(shape[0]).uniform(size=shape)
    Sj = np.asarray(ji.convex_hull_anchors(V))
    St = ti.convex_hull_anchors(V, **CPU)
    assert torch.is_tensor(St) and np.array_equal(St.numpy(), Sj)


def test_convhull_2d_is_the_monotone_chain():
    """The port's Python chain gives the native chain's vertex set, and
    skips non-finite points."""
    from nmf_toolbox_tpu import native
    pts = np.random.default_rng(8).normal(size=(300, 2))
    want = native.convhull2d(pts)
    if want is None:
        want = ji._convhull_2d(pts)
    assert np.array_equal(ti._convhull_2d(pts), want)
    pts[[3, 7]] = np.nan
    got = ti._convhull_2d(pts)
    assert 3 not in got and 7 not in got and np.all(np.isfinite(pts[got]))


def test_convex_hull_anchors_randomized_path_and_edges():
    V = np.random.default_rng(5).uniform(size=(1100, 80))
    S = ti.convex_hull_anchors(V, seed=2, **CPU)
    assert S.shape[0] == 1100 and S.shape[1] >= 3
    cols = {tuple(c) for c in V.T.tolist()}
    assert all(tuple(c) in cols for c in S.T.tolist())  # columns of V
    assert torch.equal(S, ti.convex_hull_anchors(V, seed=2, **CPU))  # seeded
    row = ti.convex_hull_anchors(np.array([[3.0, 1.0, 2.0]]), **CPU)
    assert row.tolist() == [[1.0, 3.0]]


def test_default_inits_run_and_are_seeded():
    V, *_ = data(6)
    for name in ("lnmf", "seminmf", "convexnmf", "chnmf"):
        a, b = (getattr(tt, name)(V, K, maxiter=5, seed=3, **CPU) for _ in range(2))
        assert torch.equal(a.H, b.H) and np.all(np.isfinite(a.cost)), name
    g = tt.convexnmf(V, K, maxiter=1, seed=7, **CPU)
    assert bool(torch.all(g.G > 0))  # no frozen zeros in the default G


# ---------------------------------------------------------------------------
# Carrying factors from the JAX package; errors; devices
# ---------------------------------------------------------------------------

def test_port_resumes_from_jax_result():
    """A JAX chnmf run's S, G and H, carried over by
    interop.factors_from_numpy, continue in the port as JAX continues."""
    V, _, H0, G0 = data(7)
    kw = dict(maxiter=6, tolerance=1e-30)
    first = jt.chnmf(V, K, S_init=V[:, :5], G_init=G0[:5], H_init=H0,
                     dtype=np.float64, **kw)
    S, G, H = factors_from_numpy(first, fields=("S", "G", "H"), **CPU)
    t = tt.chnmf(V, K, S_init=S, G_init=G, H_init=H, **kw, **CPU)
    j = jt.chnmf(V, K, S_init=first.S, G_init=first.G, H_init=first.H,
                 dtype=np.float64, **kw)
    assert_parity(t, j, FIELDS["chnmf"])
    with pytest.raises(ValueError, match="missing"):
        factors_from_numpy(first, fields=("G", "Z"), **CPU)


ERRORS = {
    "convexnmf_compat_no_g": ("convexnmf", {"compat": "reference"}, "G_init"),
    "convexnmf_bad_compat": ("convexnmf", {"compat": "x"}, "compat must be"),
    "chnmf_compat_not_square": ("chnmf", {"compat": "reference",
                                          "S_init": np.ones((M, 7))}, "p == k"),
    "chnmf_bad_compat": ("chnmf", {"compat": "x", "S_init": np.ones((M, 3))},
                         "compat must be"),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_errors_as_jax(case):
    name, cfg, match = ERRORS[case]
    V, *_ = data(8)
    with pytest.raises(ValueError, match=match):
        getattr(jt, name)(V, K, maxiter=2, **cfg)
    with pytest.raises(ValueError, match=match):
        getattr(tt, name)(V, K, maxiter=2, **cfg, **CPU)


SOLVERS = ("lnmf", "seminmf", "convexnmf", "chnmf")


@pytest.mark.parametrize("name", SOLVERS)
def test_mesh_not_ported(name):
    """mesh= is ported (tests/test_torch_parallel_solvers.py); a mesh
    that is not a parallel.make_mesh one raises TypeError."""
    V, *_ = data(9)
    with pytest.raises(TypeError, match="make_mesh"):
        getattr(tt, name)(V, K, maxiter=2, mesh=object(), **CPU)


ENTRY = {
    **{name: (lambda V, _n=name: getattr(tt, _n)(V, K, maxiter=2)) for name in SOLVERS},
    "kmeans": lambda V: ti.kmeans(None, V.T, K),
    "kmeans_indicator_h": lambda V: ti.kmeans_indicator_h(None, V, K),
    "convex_hull_anchors": lambda V: ti.convex_hull_anchors(V),
}


@pytest.mark.parametrize("name", sorted(ENTRY))
def test_arrays_default_to_the_card_and_raise_without_one(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    V, *_ = data(10)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ENTRY[name](V)
