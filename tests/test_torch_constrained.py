"""Port's constrainednmf (nmf_toolbox_tpu_torch.constrainednmf) against
the JAX package.

Same NumPy inputs, labels and injected inits on both sides, f64 on the
CPU: W, H, Z and the cost trace agree to rtol 1e-9, A exactly, n_iters
and converged are equal; the stored golden holds at
tests/test_goldens.py's tolerances.
"""
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False

import nmf_toolbox_tpu as jt  # noqa: E402
import nmf_toolbox_tpu_torch as tt  # noqa: E402
from nmf_toolbox_tpu_torch.interop import factors_from_numpy  # noqa: E402

GOLD = pathlib.Path(__file__).parent / "goldens"
RTOL = 1e-9
CPU = {"device": "cpu"}  # the port runs arrays on the card unless told
M, N, K = 14, 24, 3


def problem(seed, unlabeled=8, classes=3):
    """V, labels (``unlabeled`` of them -1, ids 5.. for the classes), W0
    and a Z0 of the matching width."""
    rng = np.random.default_rng(seed)
    V = rng.uniform(0.1, 1.0, (M, N))
    labels = 5 + rng.integers(0, classes, N)
    labels[rng.choice(N, unlabeled, replace=False)] = -1
    n_cls = len(np.unique(labels[labels > -1]))
    return (V, labels, rng.uniform(size=(M, K)),
            rng.uniform(size=(K, unlabeled + n_cls)))


def assert_parity(t, j):
    for name in ("W", "H", "Z"):
        a, b = getattr(t, name), np.asarray(getattr(j, name))
        assert torch.is_tensor(a) and a.device.type == "cpu", name
        np.testing.assert_allclose(a.numpy(), b, rtol=RTOL,
                                   atol=RTOL * np.max(np.abs(b)), err_msg=name)
    assert isinstance(t.A, np.ndarray)
    np.testing.assert_array_equal(t.A, j.A)
    assert t.cost.shape == np.shape(j.cost)
    np.testing.assert_allclose(t.cost, np.asarray(j.cost), rtol=RTOL, atol=0)
    assert (t.n_iters, t.converged) == (j.n_iters, j.converged)


def _weights(seed):
    return (np.random.default_rng(seed).uniform(size=(M, N)) < 0.8).astype(float)


# (labels: unlabeled count, config)
CASES = {
    "euclidean": (8, {}),
    "kl": (8, {"divergence": "kl"}),
    "is": (8, {"divergence": "is"}),
    "ab": (8, {"divergence": "ab", "alpha": 0.5, "beta": 1.5}),
    "sparsity": (8, {"W_sparsity": 0.1, "Z_sparsity": 0.2}),
    "w_fixed": (8, {"W_fixed": True}),
    "z_fixed": (8, {"Z_fixed": True}),
    "weights_kl": (8, {"divergence": "kl", "weights": _weights(1)}),
    "weights_euclidean": (8, {"weights": _weights(2)}),
    "cost_every_kl": (8, {"divergence": "kl", "cost_every": 4}),
    "stops": (8, {"divergence": "kl", "tolerance": 0.05}),
    "all_labeled": (0, {"divergence": "kl"}),
    "all_unlabeled": (N, {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_parity_with_jax(case):
    unlabeled, cfg = CASES[case]
    V, labels, W0, Z0 = problem(3, unlabeled)
    kw = {"W_init": W0, "Z_init": Z0, "maxiter": 20, "tolerance": 1e-12, **cfg}
    j = jt.constrainednmf(V, labels, K, dtype=np.float64, **kw)
    assert_parity(tt.constrainednmf(V, labels, K, **kw, **CPU), j)
    if case == "stops":
        assert j.converged and j.n_iters < 20


def test_golden():
    g = np.load(GOLD / "constrainednmf_kl.npz")
    r = tt.constrainednmf(g["V"], g["labels"], g["W0"].shape[1], W_init=g["W0"],
                          Z_init=g["Z0"], divergence="kl", maxiter=15,
                          tolerance=1e-12, dtype=np.float64, **CPU)
    for f in ("W", "H", "Z"):
        np.testing.assert_allclose(getattr(r, f).numpy(), g[f], atol=1e-9, err_msg=f)
    np.testing.assert_array_equal(r.A, g["A"])
    np.testing.assert_allclose(r.cost, g["cost"], rtol=1e-9)


def test_label_structure_and_cadence():
    """Labeled samples of one class share their H column (H = Z A), the
    all-labeled and all-unlabeled A have their shapes, and cost_every
    leaves the factors bit-identical."""
    V, labels, W0, Z0 = problem(4)
    kw = dict(W_init=W0, Z_init=Z0, divergence="kl", maxiter=12, **CPU)
    r1, r4 = (tt.constrainednmf(V, labels, K, cost_every=ce, **kw) for ce in (1, 4))
    assert torch.equal(r1.W, r4.W) and torch.equal(r1.Z, r4.Z)
    H = r1.H.numpy()
    for c in np.unique(labels[labels > -1]):
        cols = H[:, labels == c]
        assert np.array_equal(cols, np.repeat(cols[:, :1], cols.shape[1], axis=1))
    a = tt.constrainednmf(V, np.full(N, 7), K, maxiter=3, seed=1, **CPU)
    assert a.A.shape == (1, N)
    u = tt.constrainednmf(V, np.full(N, -1), K, maxiter=3, seed=1, **CPU)
    assert np.array_equal(u.A, np.eye(N)) and torch.equal(u.H, u.Z)


def test_port_continues_jax_result():
    """A JAX run's W and Z, carried over by interop, go on in the port as
    in JAX."""
    V, labels, W0, Z0 = problem(5)
    kw = dict(divergence="kl", maxiter=5, tolerance=1e-30)
    first = jt.constrainednmf(V, labels, K, W_init=W0, Z_init=Z0,
                              dtype=np.float64, **kw)
    W, Z, A = factors_from_numpy(first, fields=("W", "Z", "A"), **CPU)
    assert A.shape == first.A.shape
    assert_parity(tt.constrainednmf(V, labels, K, W_init=W, Z_init=Z, **kw, **CPU),
                  jt.constrainednmf(V, labels, K, W_init=first.W, Z_init=first.Z,
                                    dtype=np.float64, **kw))


VALIDATION = {
    "label_length": ({"labels": np.zeros(5)}, "label vector"),
    "ab_zero": ({"divergence": "ab", "alpha": 0.0, "beta": 0.0}, "alpha = 0"),
    "weights_shape": ({"weights": np.ones((3, 3))}, "weights has shape"),
    "weights_negative": ({"weights": -np.ones((M, N))}, "nonnegative"),
}


@pytest.mark.parametrize("case", sorted(VALIDATION))
def test_validation_as_jax(case):
    cfg, match = VALIDATION[case]
    V, labels, *_ = problem(6)
    cfg = dict(cfg)
    labels = cfg.pop("labels", labels)
    with pytest.raises(ValueError, match=match):
        jt.constrainednmf(V, labels, K, maxiter=2, **cfg)
    with pytest.raises(ValueError, match=match):
        tt.constrainednmf(V, labels, K, maxiter=2, **cfg, **CPU)


def test_mesh_not_ported():
    """mesh= is ported (tests/test_torch_parallel_solvers.py); a mesh
    that is not a parallel.make_mesh one raises TypeError."""
    V, labels, *_ = problem(7)
    with pytest.raises(TypeError, match="make_mesh"):
        tt.constrainednmf(V, labels, K, maxiter=2, mesh=object(), **CPU)


def test_arrays_default_to_the_card_and_raise_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    V, labels, *_ = problem(8)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tt.constrainednmf(V, labels, K, maxiter=2)
