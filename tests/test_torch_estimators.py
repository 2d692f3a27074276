"""The port's sklearn facade (``nmf_toolbox_tpu_torch.estimators.NMF``)
against the JAX package's.  Mirrors tests/test_estimators.py (9 tests) in
f64 on the CPU (``device="cpu"`` through ``**config``); where both
facades get the same injected inits, ``components_`` and the encodings
agree within rtol 1e-9.  Everything the port's facade returns is NumPy."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False

from nmf_toolbox_tpu.estimators import NMF as JNMF  # noqa: E402
from nmf_toolbox_tpu_torch.estimators import NMF  # noqa: E402

RTOL = 1e-9
CPU = {"device": "cpu"}


def close(a, b, rtol=RTOL):
    assert isinstance(a, np.ndarray) and a.shape == np.shape(b)
    b = np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * np.max(np.abs(b)))


def inits(X, k, seed):
    """W_init (features x k) and H_init (k x samples) in solver layout."""
    rng = np.random.default_rng(seed)
    return {"W_init": rng.uniform(size=(X.shape[1], k)),
            "H_init": rng.uniform(size=(k, X.shape[0]))}


def test_fit_transform_shapes_and_reconstruction():
    rng = np.random.default_rng(0)
    X = rng.gamma(2.0, 1.0, (120, 6)) @ rng.gamma(1.0, 1.0, (6, 40)) + 0.01
    kw = dict(n_components=6, max_iter=150, tol=1e-9, random_state=1,
              dtype=np.float64, **inits(X, 6, 0))
    est = NMF(**kw, **CPU)
    Ht = est.fit_transform(X)
    assert isinstance(Ht, np.ndarray) and Ht.shape == (120, 6)
    assert est.components_.shape == (6, 40)
    rec = est.inverse_transform(Ht)
    assert np.linalg.norm(X - rec) / np.linalg.norm(X) < 0.1
    assert est.n_iter_ > 0 and est.reconstruction_err_ > 0
    assert isinstance(est.cost_trace_, np.ndarray)
    ref = JNMF(**kw)
    close(Ht, ref.fit_transform(X))
    close(est.components_, ref.components_)
    assert est.n_iter_ == ref.n_iter_
    np.testing.assert_allclose(est.cost_trace_, ref.cost_trace_, rtol=RTOL)


def test_transform_new_data():
    rng = np.random.default_rng(1)
    W = rng.gamma(2.0, 1.0, (30, 4))
    X_train = (rng.gamma(1.0, 1.0, (80, 4)) @ W.T) + 0.01
    X_new = (rng.gamma(1.0, 1.0, (10, 4)) @ W.T) + 0.01
    kw = dict(n_components=4, max_iter=200, tol=1e-10, random_state=2, dtype=np.float64)
    est = NMF(**kw, **CPU).fit(X_train)
    Ht = est.transform(X_new)
    rel = np.linalg.norm(X_new - est.inverse_transform(Ht)) / np.linalg.norm(X_new)
    assert isinstance(Ht, np.ndarray) and Ht.shape == (10, 4) and rel < 0.2
    # the JAX facade given the port's basis encodes the same: transform
    # draws its H init from the seed, so inject one into both
    H0 = np.random.default_rng(3).uniform(size=(4, 10))
    est.config["H_init"] = H0
    ref = JNMF(**kw, H_init=H0)
    ref.components_ = est.components_
    close(est.transform(X_new), ref.transform(X_new))


def test_hals_solver_and_kl():
    rng = np.random.default_rng(2)
    X = rng.uniform(0.1, 1, (50, 20))
    kw = dict(n_components=3, solver="hals", max_iter=50, dtype=np.float64,
              random_state=3, **inits(X, 3, 1))
    a = NMF(**kw, **CPU)
    Ht = a.fit_transform(X)
    assert np.all(Ht >= 0)
    close(Ht, JNMF(**kw).fit_transform(X))
    b = NMF(n_components=3, divergence="kl", max_iter=20, dtype=np.float64, **CPU)
    b.fit(X)
    assert b.cost_trace_.shape[0] <= 20


def test_transform_refuses_unfixable_solver():
    rng = np.random.default_rng(3)
    X = rng.uniform(0.1, 1, (30, 12))
    est = NMF(n_components=3, solver="convexnmf", max_iter=5, dtype=np.float64,
              **CPU).fit(X)
    assert isinstance(est.components_, np.ndarray)
    with pytest.raises(NotImplementedError):
        est.transform(X)


def test_fit_refuses_3d_basis_solver():
    rng = np.random.default_rng(4)
    X = rng.uniform(0.1, 1, (30, 12))
    with pytest.raises(ValueError, match="3-D basis"):
        NMF(n_components=3, solver="cnmf", solver_args=(2,), max_iter=3,
            dtype=np.float64, **CPU).fit(X)


def test_nmfsc_solver_facade_roundtrip():
    rng = np.random.default_rng(5)
    X = rng.gamma(2.0, 1.0, (60, 4)) @ rng.gamma(1.0, 1.0, (4, 24)) + 0.01
    ini = inits(X, 4, 2)
    ini["H_init"] /= np.sqrt((ini["H_init"] ** 2).sum(1, keepdims=True))
    kw = dict(n_components=4, solver="nmfsc", H_sparsity=0.5, max_iter=30,
              dtype=np.float64, random_state=6, **ini)
    est = NMF(**kw, **CPU).fit(X)
    close(est.components_, JNMF(**kw).fit(X).components_)
    est.config.pop("H_init")  # fit-shaped; transform encodes 5 samples
    Ht = est.transform(X[:5])
    assert Ht.shape == (5, 4) and np.all(np.isfinite(Ht))


def test_sklearn_params_protocol():
    est = NMF(n_components=3, divergence="kl", H_sparsity=0.1, device="cpu")
    p = est.get_params()
    assert p["n_components"] == 3 and p["H_sparsity"] == 0.1 and p["device"] == "cpu"
    est.set_params(max_iter=7, H_sparsity=0.2)
    assert est.max_iter == 7 and est.config["H_sparsity"] == 0.2


def test_facade_hals_weights():
    """solver='hals' + weights= (sklearn orientation, like X)."""
    rng = np.random.default_rng(21)
    X = rng.uniform(0.1, 1.0, (25, 18))
    w = (rng.uniform(size=(25, 18)) < 0.8).astype(np.float64)
    kw = dict(n_components=3, solver="hals", max_iter=10, tol=1e-12, random_state=2,
              weights=w, **inits(X, 3, 3))
    est = NMF(**kw, **CPU)
    Ht = est.fit_transform(X)
    assert Ht.shape == (25, 3) and np.isfinite(est.reconstruction_err_)
    close(Ht, JNMF(**kw).fit_transform(X))


def test_auto_rank():
    """n_components='auto' reads the rank off the port's randomized-SVD
    energy curve (rank.estimate_rank_svd)."""
    rng = np.random.default_rng(30)
    X = (rng.random((60, 3)) @ rng.random((3, 40))).astype(np.float64)
    est = NMF(rank_energy=0.999, max_iter=50, random_state=1, **CPU)
    Ht = est.fit_transform(X)
    assert est.n_components_ <= 3
    assert est.n_components_ == JNMF(rank_energy=0.999, max_iter=5).fit(X).n_components_
    assert Ht.shape == (60, est.n_components_)
    assert est.components_.shape[0] == est.n_components_
    assert est.transform(X).shape == (60, est.n_components_)
    assert NMF(n_components=4, max_iter=5, **CPU).fit(X).n_components_ == 4


@pytest.mark.parametrize("method", ["naive", "fused"])
def test_method_is_forwarded(method):
    """method= reaches nmf: on CPU tensors the fused step runs the
    kernels' plain versions, and agrees with naive."""
    rng = np.random.default_rng(31)
    X = rng.uniform(0.1, 1, (40, 30)).astype(np.float32)
    kw = dict(n_components=4, divergence="kl", max_iter=10, tol=1e-30,
              **inits(X.astype(np.float32), 4, 4))
    Ht = NMF(method=method, **kw, **CPU).fit_transform(X)
    ref = NMF(method="naive", **kw, **CPU).fit_transform(X)
    np.testing.assert_allclose(Ht, ref, rtol=1e-4, atol=1e-4 * np.max(ref))
