"""Port's nmf_hals (nmf_toolbox_tpu_torch.nmf_hals) against the JAX package.

Parity is held in f64 with injected inits (the two packages' seeded
default inits draw different numbers).  Both sides run the same sweeps
and differ only in the summation order of their matrix products, so
W, H and the cost trace agree to 1e-9 relative to their scale (about
1e-11 is measured; extrapolated H grows to ~1e3 over 25 iterations, so
an absolute bound would be meaningless), with the same ``n_iters`` and
``converged``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import nmf_toolbox_tpu as jt  # noqa: E402
import nmf_toolbox_tpu_torch as tt  # noqa: E402
from nmf_toolbox_tpu_torch.interop import resume_state_from_numpy  # noqa: E402

RTOL = 1e-9  # f64, same sweeps, different matmul order; relative to scale
CPU = {"device": "cpu"}  # the port runs arrays on the card unless told


def _problem(seed=0, m=30, n=40, k=5):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.1, 1.0, (m, n)), rng.uniform(size=(m, k)),
            rng.uniform(size=(k, n)))


def close(a, b, rtol=RTOL):
    a = a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0, atol=rtol * np.max(np.abs(b)))


def assert_parity(t, j):
    close(t.W, j.W)
    close(t.H, j.H)
    assert isinstance(t.cost, np.ndarray) and t.cost.shape == np.shape(j.cost)
    np.testing.assert_allclose(t.cost, j.cost, rtol=RTOL, atol=0)
    assert t.n_iters == j.n_iters
    assert t.converged == j.converged


@pytest.mark.parametrize("extra", [
    {}, {"inner_iters": 3}, {"extrapolate": True}, {"weights": "mask"},
    {"tolerance": 1e-3, "maxiter": 500},
], ids=["plain", "inner3", "extrapolate", "weights", "stops"])
def test_parity_f64(extra):
    V, W0, H0 = _problem()
    if extra.get("weights") == "mask":
        extra = {"weights": (np.random.default_rng(1).uniform(size=V.shape) < 0.7)
                 .astype(np.float64)}
    kw = dict(W_init=W0, H_init=H0, maxiter=25, tolerance=1e-12)
    kw.update(extra)
    t, j = tt.nmf_hals(V, 5, **kw, **CPU), jt.nmf_hals(V, 5, **kw)
    assert_parity(t, j)
    assert t.W.dtype == torch.float64 and t.W.device.type == "cpu"
    if "tolerance" in extra:
        assert t.converged and t.n_iters < 500 and len(t.cost) == t.n_iters
    if "extrapolate" in extra:
        for key in ("Wy", "Hy"):
            close(t.resume_state[key], j.resume_state[key])
        for key in ("beta", "beta_bar", "prev_err"):
            assert isinstance(t.resume_state[key], float)
            np.testing.assert_allclose(t.resume_state[key],
                                       j.resume_state[key], rtol=RTOL)


def test_weighted_nan_at_zero_weight():
    V, W0, H0 = _problem(2)
    M = (np.random.default_rng(3).uniform(size=V.shape) < 0.7).astype(np.float64)
    V_nan = np.where(M > 0, V, np.nan)
    kw = dict(W_init=W0, H_init=H0, weights=M, maxiter=20, tolerance=1e-30)
    t = tt.nmf_hals(V_nan, 5, **kw, **CPU)
    assert_parity(t, jt.nmf_hals(V_nan, 5, **kw))
    c = t.cost
    assert np.all(np.isfinite(c))
    assert np.all(np.diff(c) <= 1e-9 * np.abs(c[:-1]) + 1e-12)  # monotone


def test_stops_at_exact_fit():
    """tests/test_hals.py::test_hals_stops_at_exact_fit: a perfectly
    factorizable V drives the clamped cost to 0; the inclusive stop rule
    ends the run instead of spinning to maxiter."""
    rng = np.random.default_rng(5)
    W = rng.gamma(2.0, 1.0, (40, 3))
    H = rng.gamma(1.0, 1.0, (3, 50))
    V = (W @ H).astype(np.float32)
    r = tt.nmf_hals(V, 3, W_init=W.astype(np.float32),
                    H_init=H.astype(np.float32), maxiter=500, tolerance=1e-12, **CPU)
    assert r.converged and len(r.cost) < 500


def test_extrapolated_chunked_resume_bit_exact():
    """The momentum state rides through resume_state: chained chunks of
    7 iterations give the bits of one 30-iteration run."""
    V, _, _ = _problem(11, m=50, n=40, k=4)
    kw = dict(extrapolate=True, tolerance=1e-30, seed=3)
    whole = tt.nmf_hals(V, 4, maxiter=30, **kw, **CPU)
    res, costs, done = None, [], 0
    while done < 30:
        step = min(7, 30 - done)
        more = {} if res is None else dict(W_init=res.W, H_init=res.H,
                                           resume_state=res.resume_state)
        res = tt.nmf_hals(V, 4, maxiter=step, **kw, **more, **CPU)
        costs.append(res.cost)
        done += step
    assert torch.equal(res.W, whole.W) and torch.equal(res.H, whole.H)
    assert np.array_equal(np.concatenate(costs), whole.cost)
    for key in ("Wy", "Hy"):
        assert torch.equal(res.resume_state[key], whole.resume_state[key])


def test_port_resumes_jax_state():
    """JAX runs 10 extrapolated iterations; the port continues for 10
    from JAX's factors and momentum state, matching JAX's 20 at once."""
    V, W0, H0 = _problem(12)
    kw = dict(extrapolate=True, tolerance=1e-30)
    first = jt.nmf_hals(V, 5, W_init=W0, H_init=H0, maxiter=10, **kw)
    rs = resume_state_from_numpy(first.resume_state, **CPU)
    assert rs["Wy"].dtype == torch.float64 and isinstance(rs["beta"], float)
    t = tt.nmf_hals(V, 5, W_init=first.W, H_init=first.H, resume_state=rs,
                    maxiter=10, **kw, **CPU)
    whole = jt.nmf_hals(V, 5, W_init=W0, H_init=H0, maxiter=20, **kw)
    close(t.W, whole.W)
    close(t.H, whole.H)
    np.testing.assert_allclose(t.cost, np.asarray(whole.cost)[10:], rtol=RTOL)


def test_resume_state_from_numpy():
    rs = {"Wy": np.ones((3, 2)), "Hy": np.full((2, 4), 2.0), "beta": np.float32(0.5),
          "beta_bar": 1.0, "prev_err": 3.0}
    out = resume_state_from_numpy(rs, dtype=np.float32, **CPU)
    assert out["Wy"].dtype == torch.float32 and out["Hy"].shape == (2, 4)
    assert out["beta"] == 0.5 and type(out["beta"]) is float
    rs["Wy"][0, 0] = 7.0  # a copy, not a view
    assert float(out["Wy"][0, 0]) == 1.0
    with pytest.raises(ValueError, match="prev_err"):
        resume_state_from_numpy({k: v for k, v in rs.items() if k != "prev_err"}, **CPU)


@pytest.mark.parametrize("extra", [{}, {"extrapolate": True}, {"weights": 1}],
                         ids=["plain", "extrapolate", "weights"])
@pytest.mark.parametrize("k", [1, 3])
def test_inits_are_not_written(extra, k):
    V, W0, H0 = _problem(13, k=k)
    if "weights" in extra:
        extra = {"weights": np.ones_like(V)}
    W, H = torch.from_numpy(W0.copy()), torch.from_numpy(H0.copy())
    tt.nmf_hals(V, k, W_init=W, H_init=H, maxiter=3, **extra, **CPU)
    assert np.array_equal(W.numpy(), W0) and np.array_equal(H.numpy(), H0)


def test_default_init_and_f32():
    V, _, _ = _problem(14)
    a, b = (tt.nmf_hals(V.astype(np.float32), 4, maxiter=20, seed=5, **CPU) for _ in range(2))
    assert a.W.dtype == torch.float32 and torch.equal(a.W, b.W)
    W, H, cost = a  # unpacks like the MATLAB-style call
    assert W.shape == (30, 4) and H.shape == (4, 40)
    assert np.all(np.diff(cost) <= 1e-6 * cost[:-1])  # HALS is monotone
    assert a.resume_state is None


GUARDS = [
    dict(init="svd"),
    dict(init="nndsvd", W_init=np.ones((20, 3))),
    dict(inner_iters=0),
    dict(weights=np.ones((20, 20)), extrapolate=True),
    dict(weights=np.ones((20, 20)), inner_iters=2),
    dict(weights=-np.ones((20, 20))),
    dict(weights=np.ones((20, 19))),
]


@pytest.mark.parametrize("cfg", GUARDS)
def test_guards_raise_value_error(cfg):
    V = np.random.default_rng(6).uniform(0.1, 1, (20, 20))
    with pytest.raises(ValueError):
        jt.nmf_hals(V, 3, maxiter=2, **cfg)
    with pytest.raises(ValueError):
        tt.nmf_hals(V, 3, maxiter=2, **cfg, **CPU)


def test_mesh_not_ported():
    V = np.random.default_rng(8).uniform(0.1, 1, (20, 20))
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 13"):
        tt.nmf_hals(V, 3, maxiter=2, mesh=object(), **CPU)
