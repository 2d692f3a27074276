"""Port's nmf (nmf_toolbox_tpu_torch.nmf) against the JAX package.

Parity is held with injected inits (the two packages' seeded default
inits draw different numbers).  In f64 both sides run the same updates
and differ only in the summation order of their matmuls, so factors
agree to atol 1e-10 and costs to rtol 1e-10 over tens of iterations.
"""
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import nmf_toolbox_tpu as jt  # noqa: E402
import nmf_toolbox_tpu_torch as tt  # noqa: E402
from nmf_toolbox_tpu_torch.interop import (  # noqa: E402
    factors_from_numpy, resume_state_from_numpy)
from nmf_toolbox_tpu_torch.ops.kernels import fused as fk  # noqa: E402
from nmf_toolbox_tpu_torch.utils.init import nndsvd  # noqa: E402

GOLD = pathlib.Path(__file__).parent / "goldens"
ATOL = 1e-10  # f64 factors, same updates, different matmul order
RTOL = 1e-10  # f64 cost trace
CPU = {"device": "cpu"}  # the port runs arrays on the card unless told


def _problem(seed=0, m=30, n=40, k=5):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.1, 1.0, (m, n)), rng.uniform(size=(m, k)),
            rng.uniform(size=(k, n)))


def np_(x):
    return [np_(a) for a in x] if isinstance(x, list) else x.detach().cpu().numpy()


def assert_parity(t, j, atol=ATOL, rtol=RTOL):
    for name in ("W", "H"):
        tv, jv = getattr(t, name), getattr(j, name)
        if isinstance(jv, list):
            assert isinstance(tv, list) and len(tv) == len(jv)
        else:
            tv, jv = [tv], [jv]
        for a, b in zip(tv, jv):
            assert torch.is_tensor(a)
            np.testing.assert_allclose(np_(a), b, atol=atol, rtol=0)
    assert isinstance(t.cost, np.ndarray)
    assert t.cost.shape == np.shape(j.cost)
    np.testing.assert_allclose(t.cost, j.cost, rtol=rtol, atol=0)
    assert t.n_iters == j.n_iters
    assert t.converged == j.converged


# ---------------------------------------------------------------------------
# Goldens (tests/test_goldens.py's tolerances)
# ---------------------------------------------------------------------------

def test_golden_nmf_kl():
    g = np.load(GOLD / "nmf_kl.npz")
    r = tt.nmf(g["V"], g["W0"].shape[1], W_init=g["W0"], H_init=g["H0"],
               divergence="kl", maxiter=20, tolerance=1e-12, dtype=np.float64,
               **CPU)
    np.testing.assert_allclose(np_(r.W), g["W"], atol=1e-9)
    np.testing.assert_allclose(np_(r.H), g["H"], atol=1e-9)
    np.testing.assert_allclose(r.cost, g["cost"], rtol=1e-9)


def test_golden_nmf_weighted_kl():
    g = np.load(GOLD / "nmf_weighted_kl.npz")
    r = tt.nmf(g["V"], g["W0"].shape[1], W_init=g["W0"], H_init=g["H0"],
               weights=g["M"], divergence="kl", maxiter=15, tolerance=1e-12,
               dtype=np.float64, **CPU)
    np.testing.assert_allclose(np_(r.W), g["W"], atol=1e-9)
    np.testing.assert_allclose(np_(r.H), g["H"], atol=1e-9)
    np.testing.assert_allclose(r.cost, g["cost"], rtol=1e-9)


# ---------------------------------------------------------------------------
# Cross-package parity in f64
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("div,method,extra", [
    ("euclidean", "gram", {}),
    ("euclidean", "gram", {"inner_iters": 2}),
    ("kl", "naive", {}),
    ("is", "naive", {}),
    ("ab", "naive", {"alpha": 0.5, "beta": 1.5}),
])
def test_parity_f64(div, method, extra):
    V, W0, H0 = _problem()
    kw = dict(W_init=W0, H_init=H0, divergence=div, method=method,
              maxiter=25, tolerance=1e-12, **extra)
    assert_parity(tt.nmf(V, 5, **kw, **CPU), jt.nmf(V, 5, **kw))


def test_parity_weighted_and_euclidean_naive():
    V, W0, H0 = _problem(1)
    Mw = np.random.default_rng(2).uniform(0.0, 1.0, V.shape)
    for div in ("euclidean", "is"):
        kw = dict(W_init=W0, H_init=H0, divergence=div, weights=Mw,
                  maxiter=15, tolerance=1e-12)
        assert_parity(tt.nmf(V, 5, **kw, **CPU), jt.nmf(V, 5, **kw))


def test_parity_multi_source_fixed_sparse():
    V, W0, H0 = _problem(3, k=5)
    kw = dict(W_init=[W0[:, :3], W0[:, 3:]], H_init=[H0[:3], H0[3:]],
              W_fixed=[False, True], W_sparsity=[0.0, 0.2], H_sparsity=0.1,
              divergence="kl", maxiter=20, tolerance=1e-12)
    t = tt.nmf(V, [3, 2], **kw, **CPU)
    assert_parity(t, jt.nmf(V, [3, 2], **kw))
    # The frozen source keeps its (unit-L2 normalized) init.
    w1 = W0[:, 3:] / np.sqrt((W0[:, 3:] ** 2).sum(0, keepdims=True))
    np.testing.assert_allclose(np_(t.W[1]), w1, atol=1e-15)


def test_parity_tolerance_fires_and_trims():
    V, W0, H0 = _problem(4)
    kw = dict(W_init=W0, H_init=H0, maxiter=500, tolerance=1e-3)
    t, j = tt.nmf(V, 5, **kw, **CPU), jt.nmf(V, 5, **kw)
    assert t.converged and t.n_iters < 500
    assert len(t.cost) == t.n_iters
    assert_parity(t, j)


@pytest.mark.parametrize("div,method,dtype", [
    ("euclidean", "gram", np.float64), ("kl", "naive", np.float64),
    ("is", "fused", np.float32),
])
def test_cost_every_leaves_factors_bit_identical(div, method, dtype):
    V, W0, H0 = _problem(5)
    kw = dict(W_init=W0, H_init=H0, divergence=div, method=method,
              maxiter=20, tolerance=0.0, dtype=dtype)
    r1 = tt.nmf(V, 5, **kw, **CPU)
    r3 = tt.nmf(V, 5, cost_every=3, **kw, **CPU)
    assert torch.equal(r1.W, r3.W) and torch.equal(r1.H, r3.H)
    # computed at iterations 1, 3, 6, ..., 18 and the last; carried between
    for i in range(20):
        if i == 0 or (i + 1) % 3 == 0 or i == 19:
            assert r3.cost[i] == r1.cost[i]
        else:
            assert r3.cost[i] == r3.cost[i - 1]


def test_cost_every_matches_jax():
    V, W0, H0 = _problem(6)
    kw = dict(W_init=W0, H_init=H0, divergence="kl", maxiter=300,
              tolerance=2e-2, cost_every=4)
    t = tt.nmf(V, 5, **kw, **CPU)
    assert t.converged
    assert_parity(t, jt.nmf(V, 5, **kw))


# ---------------------------------------------------------------------------
# The fused method on the CPU (the kernels' plain versions), f32
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("div", ["kl", "is"])
def test_fused_f32(div):
    rng = np.random.default_rng(5)
    m, n, k = 150, 200, 10
    V = rng.uniform(0.1, 1, (m, n)).astype(np.float32)
    W0 = rng.uniform(size=(m, k)).astype(np.float32)
    H0 = rng.uniform(size=(k, n)).astype(np.float32)
    kw = dict(W_init=W0, H_init=H0, divergence=div, maxiter=8,
              tolerance=1e-30, dtype=np.float32)
    before = (fk.phi_dot_ht_launches, fk.wt_dot_phi_launches, fk.cost_terms_launches)
    t = tt.nmf(V, k, method="fused", **kw, **CPU)
    assert (fk.phi_dot_ht_launches, fk.wt_dot_phi_launches,
            fk.cost_terms_launches) == before  # CPU: plain versions only
    assert t.W.dtype == torch.float32
    # Port vs JAX, both fused in f32: different summation orders, 1e-4.
    j = jt.nmf(V, k, method="fused", **kw)
    np.testing.assert_allclose(t.cost, j.cost, rtol=1e-4)
    # Port fused vs port naive: tests/test_pallas.py's thresholds.
    a = tt.nmf(V, k, method="naive", **kw, **CPU)
    np.testing.assert_allclose(a.cost, t.cost, rtol=2e-3)
    np.testing.assert_allclose(np_(a.W), np_(t.W), atol=2e-3)
    np.testing.assert_allclose(np_(a.H), np_(t.H), atol=2e-2)


# ---------------------------------------------------------------------------
# Guards
# ---------------------------------------------------------------------------

GUARDS = [
    dict(divergence="euclidean", method="fused"),
    dict(divergence="kl", method="fused", dtype=np.float64),
    dict(divergence="kl", method="gram"),
    dict(divergence="hellinger"),
    dict(divergence="ab", alpha=0.0, beta=0.0),
    dict(weights=np.ones((20, 20)), method="gram"),
    dict(weights=-np.ones((20, 20))),
    dict(weights=np.ones((20, 19))),
    dict(inner_iters=0),
    dict(inner_iters=2, divergence="kl"),
    dict(cost_every=0),
    dict(init="svd"),
    dict(W_init=np.ones((20, 2))),
    dict(H_init=[np.ones((3, 20)), np.ones((3, 20))]),
]


@pytest.mark.parametrize("cfg", GUARDS)
def test_guards_raise_value_error(cfg):
    V = np.random.default_rng(6).uniform(0.1, 1, (20, 20))
    with pytest.raises(ValueError):
        jt.nmf(V, 3, maxiter=2, **cfg)
    with pytest.raises(ValueError):
        tt.nmf(V, 3, maxiter=2, **cfg, **CPU)


def test_fused_k_limit():
    V = np.random.default_rng(7).uniform(0.1, 1, (20, 20)).astype(np.float32)
    for pkg in (jt, tt):
        with pytest.raises(ValueError):
            pkg.nmf(V, 1025, divergence="kl", method="fused", maxiter=1,
                    **(CPU if pkg is tt else {}))


@pytest.mark.parametrize("cfg", [dict(mesh=object())])
def test_not_ported_options_raise(cfg):
    """mesh= takes the port's own mesh: a foreign object raises a
    TypeError naming make_mesh, and a one-rank mesh runs the meshed path
    bit-identically to no mesh (the multi-rank cases are
    tests/test_torch_parallel.py's)."""
    V = np.random.default_rng(8).uniform(0.1, 1, (20, 20))
    with pytest.raises(TypeError, match="make_mesh"):
        tt.nmf(V, 3, maxiter=2, **cfg, **CPU)
    from torch_mesh import one_rank
    from nmf_toolbox_tpu_torch.parallel import make_mesh
    for div in ("euclidean", "kl"):
        a = tt.nmf(V, 3, maxiter=4, divergence=div, **CPU)
        with one_rank():
            b = tt.nmf(V, 3, maxiter=4, divergence=div, mesh=make_mesh(1, device_type="cpu"))
        assert torch.equal(a.W, b.W) and torch.equal(a.H, b.H)
        np.testing.assert_array_equal(a.cost, b.cost)


@pytest.mark.parametrize("cost_every", [1, 3])
@pytest.mark.parametrize("stops", [True, False])
def test_callback_calls_match_jax(cost_every, stops):
    """callback(i, cost) once per executed iteration, the carried cost on
    the iterations cost_every skips, as the JAX loop's debug callback."""
    V, W0, H0 = _problem(4)
    kw = dict(W_init=W0, H_init=H0, divergence="kl", cost_every=cost_every,
              **(dict(maxiter=300, tolerance=2e-2) if stops
                 else dict(maxiter=12, tolerance=1e-30)))
    calls = {"t": [], "j": []}
    t = tt.nmf(V, 5, callback=lambda i, c: calls["t"].append((int(i), float(c))),
               **kw, **CPU)
    j = jt.nmf(V, 5, callback=lambda i, c: calls["j"].append((int(i), float(c))),
               **kw)
    assert t.converged == j.converged == stops
    assert_parity(t, j)
    got, want = np.array(calls["t"]), np.array(sorted(calls["j"]))
    assert got.shape == want.shape == (t.n_iters, 2)
    assert np.array_equal(got[:, 0], np.arange(t.n_iters))
    assert np.array_equal(got[:, 0], want[:, 0])
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=RTOL, atol=0)
    # the trace holds what the callback saw, carried entries included
    np.testing.assert_array_equal(got[:, 1], t.cost[:t.n_iters])


def test_unknown_method_raises():
    V = np.random.default_rng(9).uniform(0.1, 1, (20, 20))
    with pytest.raises(ValueError, match="unknown method"):
        tt.nmf(V, 3, method="hals", maxiter=2, **CPU)


# ---------------------------------------------------------------------------
# Devices, dtypes, seeds
# ---------------------------------------------------------------------------

def test_devices_dtypes_and_seeded_init():
    V, _, _ = _problem(10)
    r = tt.nmf(V, 4, maxiter=5, **CPU)
    assert r.W.device.type == "cpu" and r.W.dtype == torch.float64
    W, H, cost = r  # unpacks like the MATLAB call
    assert W.shape == (30, 4) and H.shape == (4, 40) and cost.shape == (5,)
    r32 = tt.nmf(torch.from_numpy(V).float(), 4, maxiter=5)
    assert r32.W.dtype == torch.float32
    with pytest.raises(ValueError):
        tt.nmf(torch.from_numpy(V), 4, maxiter=5, device="meta")
    a, b = (tt.nmf(V, 4, maxiter=5, seed=3, **CPU) for _ in range(2))
    c = tt.nmf(V, 4, maxiter=5, seed=4, **CPU)
    assert torch.equal(a.W, b.W) and not torch.equal(a.W, c.W)
    assert np.all(np.diff(a.cost) <= 0)  # Euclidean MU is monotone


ENTRY_POINTS = {
    "nmf": lambda V: tt.nmf(V, 3, maxiter=2),
    "nmf_hals": lambda V: tt.nmf_hals(V, 3, maxiter=2),
    "nndsvd": lambda V: nndsvd(V, 3),
    "factors_from_numpy": lambda V: factors_from_numpy({"W": V, "H": V}),
    "resume_state_from_numpy": lambda V: resume_state_from_numpy(
        {"Wy": V, "Hy": V, "beta": 1.0, "beta_bar": 1.0, "prev_err": 1.0}),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_arrays_default_to_the_card_and_raise_without_one(name, monkeypatch):
    """An array with no device= goes to the card, so with no card the
    entry point raises and names device="cpu", never falling back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    V = np.random.default_rng(12).uniform(0.1, 1, (20, 20))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ENTRY_POINTS[name](V)


def test_multi_source_default_init_returns_lists():
    V, _, _ = _problem(11)
    r = tt.nmf(V, [2, 3], divergence="kl", maxiter=5, **CPU)
    assert isinstance(r.W, list) and [w.shape[1] for w in r.W] == [2, 3]
    assert isinstance(r.H, list) and [h.shape[0] for h in r.H] == [2, 3]


# ---------------------------------------------------------------------------
# bench.py's objective check (bench.py:55-88), on the CPU
# ---------------------------------------------------------------------------

def test_objective_check_vs_f64_oracle():
    rng = np.random.default_rng(42)
    V = rng.uniform(0.05, 1.0, (1000, 500))
    W0 = rng.uniform(size=(1000, 25))
    H0 = rng.uniform(size=(25, 500))
    eps = np.finfo(np.float64).eps
    W, H = W0 / np.sqrt((W0 ** 2).sum(0, keepdims=True)), H0.copy()
    for _ in range(200):  # literal nmf.m:147-203 Euclidean updates in f64
        Vh = W @ H
        neg = V @ H.T + W * np.diag(H @ Vh.T @ W)[None, :]
        pos = Vh @ H.T + W * np.diag(H @ V.T @ W)[None, :]
        W = W * (neg / np.maximum(pos, eps))
        W = W / np.sqrt((W ** 2).sum(0, keepdims=True))
        Vh = W @ H
        H = H * ((W.T @ V) / np.maximum(W.T @ Vh, eps))
    c_oracle = 0.5 * np.sum((V - W @ H) ** 2)
    r = tt.nmf(V.astype(np.float32), 25, W_init=W0.astype(np.float32),
               H_init=H0.astype(np.float32), maxiter=200, tolerance=1e-30, **CPU)
    Wf, Hf = np_(r.W).astype(np.float64), np_(r.H).astype(np.float64)
    rel = abs(0.5 * np.sum((V - Wf @ Hf) ** 2) - c_oracle) / c_oracle
    assert rel <= 1e-5
