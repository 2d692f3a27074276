"""Port's complex solvers (``cmfwisa``, ``cmfwisa_encode``) against the
JAX package, tests/oracle.py, the stored golden and each other.

Both packages get the same NumPy inputs and injected inits and run in
complex128 on the CPU: cost traces within rtol 1e-9, W and H within rtol
1e-9 of their largest entry, P within 1e-9.  Two-source trajectories are
chaotic through the angle() of the phase update (a rounding difference
grows ~5x per iteration at a few bins, as the JAX package's own
tests/test_complex_and_constrained.py notes), so the two-source cases
run few iterations: 4 across the packages, 6 for the port's encoder
against its own single solver (batched products round otherwise than
single ones).
"""
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False

import nmf_toolbox_tpu as jt  # noqa: E402
import nmf_toolbox_tpu_torch as tt  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).parent))
import oracle  # noqa: E402

GOLD = pathlib.Path(__file__).parent / "goldens"
RTOL = 1e-9
CPU = {"device": "cpu"}  # the port runs arrays on the card unless told
C128 = dict(tolerance=1e-12, dtype=np.complex128)


def as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def close(a, b, rtol=RTOL):
    a = a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * np.max(np.abs(b)))


def assert_parity(t, j, fields=("W", "H", "P")):
    for name in fields:
        tv, jv = as_list(getattr(t, name)), as_list(getattr(j, name))
        assert len(tv) == len(jv), name
        for a, b in zip(tv, jv):
            assert torch.is_tensor(a) and a.device.type == "cpu", name
            close(a, b)
    assert t.cost.shape == np.shape(j.cost)
    np.testing.assert_allclose(t.cost, np.asarray(j.cost), rtol=RTOL, atol=0)
    assert (t.n_iters, t.converged) == (j.n_iters, j.converged)


def complex_data(seed, m=20, n=30):
    rng = np.random.default_rng(seed)
    return rng, rng.normal(size=(m, n)) + 1j * rng.normal(size=(m, n))


# ---------------------------------------------------------------------------
# cmfwisa
# ---------------------------------------------------------------------------

CASES = {
    "one source": dict(ks=4, iters=20),
    "one source, H_sparsity": dict(ks=4, iters=20, H_sparsity=0.3),
    "fixed W and P": dict(ks=3, iters=10, W_fixed=True, P_fixed=True),
    "fixed H": dict(ks=3, iters=10, H_fixed=True),
    "two sources": dict(ks=[4, 3], iters=4, H_sparsity=[0.1, 0.0]),
    "two sources, one P fixed": dict(ks=[2, 3], iters=4, P_fixed=[True, False],
                                     W_fixed=[False, True]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cmfwisa_matches_jax(case):
    kw = dict(CASES[case])
    ks, iters = kw.pop("ks"), kw.pop("iters")
    rng, V = complex_data(sorted(CASES).index(case))
    m, n = V.shape
    W0 = [rng.uniform(size=(m, k)) for k in as_list(ks)]
    H0 = [rng.uniform(size=(k, n)) for k in as_list(ks)]
    if not isinstance(ks, list):
        W0, H0 = W0[0], H0[0]
    t = tt.cmfwisa(V, ks, W_init=W0, H_init=H0, maxiter=iters, **C128, **kw, **CPU)
    j = jt.cmfwisa(V, ks, W_init=W0, H_init=H0, maxiter=iters, **C128, **kw)
    assert_parity(t, j)
    assert all(p.dtype == torch.complex128 for p in as_list(t.P))
    _, _, _, cg = oracle.cmfwisa(
        V, as_list(W0), as_list(H0), maxiter=iters, tolerance=1e-12,
        **{key: as_list(v) if isinstance(ks, list) else [v] for key, v in kw.items()})
    np.testing.assert_allclose(t.cost, cg, rtol=RTOL)


def test_cmfwisa_golden():
    g = np.load(GOLD / "cmfwisa.npz")
    r = tt.cmfwisa(g["V"], g["W0"].shape[1], W_init=g["W0"], H_init=g["H0"],
                   H_sparsity=float(g["H_sparsity"]), maxiter=15, **C128, **CPU)
    np.testing.assert_allclose(r.W.numpy(), g["W"], atol=1e-9)
    np.testing.assert_allclose(r.H.numpy(), g["H"], atol=1e-9)
    np.testing.assert_allclose(r.P.numpy(), g["P"], atol=1e-9)
    np.testing.assert_allclose(r.cost, g["cost"], rtol=1e-9)


def test_cmfwisa_default_phase_and_unit_modulus():
    """P_init defaults to exp(1j angle(V)); P_fixed keeps it; phases stay
    unit-modulus; a zero bin gets phase 1 (angle form, not V/|V|)."""
    rng = np.random.default_rng(2)
    m, n, k = 16, 24, 3
    mag = rng.gamma(2.0, 1.0, (m, k)) @ rng.gamma(1.0, 1.0, (k, n))
    V = mag * np.exp(1j * rng.uniform(-np.pi, np.pi, (m, n)))
    V[0, 0] = 0.0
    r = tt.cmfwisa(V, k, maxiter=50, seed=5, dtype=np.complex128, P_fixed=True, **CPU)
    np.testing.assert_allclose(r.P.numpy(), np.exp(1j * np.angle(V)), atol=1e-12)
    assert r.P[0, 0] == 1 and r.cost[-1] < r.cost[0]
    r = tt.cmfwisa(V, k, maxiter=20, seed=5, dtype=np.complex128, **CPU)
    np.testing.assert_allclose(np.abs(r.P.numpy()), 1.0, atol=1e-12)
    assert np.all(np.isfinite(r.cost))


def test_cmfwisa_dtypes_and_sources():
    rng, V = complex_data(3, 12, 18)
    r = tt.cmfwisa(V.astype(np.complex64), 3, maxiter=10, **CPU)
    assert r.P.dtype == torch.complex64 and r.W.dtype == torch.float32
    assert np.all(np.isfinite(r.cost))
    r = tt.cmfwisa(np.abs(V), [2, 2], maxiter=5, **CPU)  # real f64 V -> complex128
    assert isinstance(r.P, list) and r.P[0].dtype == torch.complex128
    assert [w.shape for w in r.W] == [(12, 2), (12, 2)]
    with pytest.raises(TypeError, match="make_mesh"):  # a foreign mesh
        tt.cmfwisa(V, 3, mesh=object(), **CPU)


# ---------------------------------------------------------------------------
# cmfwisa_encode
# ---------------------------------------------------------------------------

B, M, N, KS = 3, 10, 14, [2, 3]


def batch(seed):
    rng = np.random.default_rng(seed)
    Vs = (rng.uniform(0.1, 1, (B, M, N))
          * np.exp(1j * rng.uniform(-np.pi, np.pi, (B, M, N))))
    Ws = [rng.uniform(size=(M, k)) for k in KS]
    H0 = rng.uniform(size=(B, sum(KS), N))
    P0 = [np.exp(1j * rng.uniform(-np.pi, np.pi, (B, M, N))) for _ in KS]
    return Vs, Ws, H0, P0


ENCODE_CASES = {
    "plain": {},
    "sparsity and a fixed phase": dict(P_fixed=[True, False], H_sparsity=[0.2, 0.0]),
}


@pytest.mark.parametrize("case", sorted(ENCODE_CASES))
def test_cmfwisa_encode_matches_jax(case):
    kw = ENCODE_CASES[case]
    Vs, Ws, H0, P0 = batch(30)
    if kw:
        kw = dict(kw, P_init=P0)
    t = tt.cmfwisa_encode(Vs, Ws, H_init=H0, maxiter=4, dtype=np.complex128, **kw, **CPU)
    j = jt.cmfwisa_encode(Vs, Ws, H_init=H0, maxiter=4, dtype=np.complex128, **kw)
    assert_parity(t, j)
    assert t.H[0].shape == (B, KS[0], N) and t.P[0].shape == (B, M, N)
    assert t.cost.shape == (B, 4)
    if kw:
        np.testing.assert_array_equal(t.P[0].numpy(), P0[0])  # the fixed phase


@pytest.mark.parametrize("case", sorted(ENCODE_CASES))
def test_cmfwisa_encode_is_the_single_solver_per_problem(case):
    """Per problem, cmfwisa(V_i, ks, W_init=Ws, W_fixed=True): the batched
    products round otherwise than the single ones, and the chaotic phase
    bins amplify that, so 6 iterations."""
    kw = ENCODE_CASES[case]
    Vs, Ws, H0, P0 = batch(31)
    iters = 6
    res = tt.cmfwisa_encode(Vs, Ws, H_init=H0, maxiter=iters, dtype=np.complex128,
                            **(dict(kw, P_init=P0) if kw else {}), **CPU)
    for b in range(B):
        extra = dict(kw, P_init=[p[b] for p in P0]) if kw else {}
        ref = tt.cmfwisa(Vs[b], KS, W_init=Ws, W_fixed=True,
                         H_init=[H0[b, :KS[0]], H0[b, KS[0]:]], maxiter=iters,
                         tolerance=1e-30, dtype=np.complex128, **extra, **CPU)
        for s in range(len(KS)):
            close(res.W[s], ref.W[s].numpy(), rtol=1e-12)
            close(res.H[s][b], ref.H[s].numpy())
            close(res.P[s][b], ref.P[s].numpy())
        np.testing.assert_allclose(res.cost[b], ref.cost, rtol=RTOL)


def test_cmfwisa_encode_planes_equal_complex():
    """A (V_re, V_im) plane pair, tensors or arrays, is the complex batch."""
    Vs, Ws, H0, _ = batch(33)
    a = tt.cmfwisa_encode(Vs, Ws[0], H_init=H0[:, :2], maxiter=10,
                          dtype=np.complex128, **CPU)
    b = tt.cmfwisa_encode((torch.from_numpy(Vs.real), torch.from_numpy(Vs.imag)),
                          Ws[0], H_init=H0[:, :2], maxiter=10, dtype=np.float64, **CPU)
    c = tt.cmfwisa_encode((Vs.real, Vs.imag), Ws[0], H_init=H0[:, :2], maxiter=10, **CPU)
    for r in (b, c):
        assert torch.equal(a.H, r.H) and torch.equal(a.P, r.P)
        np.testing.assert_array_equal(a.cost, r.cost)
    assert a.P.shape == (B, M, N)  # one source: unwrapped
    # MU with a fixed basis stays monotone non-increasing
    assert np.all(np.diff(a.cost, axis=1) <= 1e-9 * np.abs(a.cost[:, :-1]))


def test_cmfwisa_encode_device_output_changes_nothing():
    Vs, Ws, H0, _ = batch(34)
    a = tt.cmfwisa_encode(Vs, Ws, H_init=H0, maxiter=5, **CPU)
    b = tt.cmfwisa_encode(Vs, Ws, H_init=H0, maxiter=5, device_output=True, **CPU)
    assert all(torch.equal(x, y) for x, y in zip(a.H + a.P, b.H + b.P))


@pytest.mark.parametrize("bad,match", [
    (dict(divergence="kl"), "divergence"),
    (dict(data_dtype="bfloat16"), "data_dtype"),
    (dict(weights=np.ones((M, N))), "weights"),
    (dict(W_fixed=True), "W_fixed"),
    (dict(P_init=np.ones((B, M, N))), "P_init"),
    (dict(H_init=np.ones((B, 1, N))), "H_init"),
])
def test_cmfwisa_encode_validation(bad, match):
    Vs, Ws, _, _ = batch(35)
    with pytest.raises(ValueError, match=match):
        tt.cmfwisa_encode(Vs, Ws, **bad, **CPU)
    with pytest.raises(ValueError):  # JAX's weights check fails on the array's truth value
        jt.cmfwisa_encode(Vs, Ws, **bad)


def test_cmfwisa_encode_shape_errors():
    Vs, Ws, _, _ = batch(36)
    with pytest.raises(ValueError, match="B, m, n"):
        tt.cmfwisa_encode(Vs[0], Ws, **CPU)
    with pytest.raises(ValueError, match="B, m, n"):
        tt.cmfwisa_encode((Vs.real, Vs.imag[:, :2]), Ws, **CPU)
    with pytest.raises(ValueError, match="dictionary"):
        tt.cmfwisa_encode(Vs, np.ones((M + 1, 2)), **CPU)
    with pytest.raises(TypeError, match="make_mesh"):
        tt.cmfwisa_encode(Vs, Ws, mesh=object(), **CPU)
    from torch_mesh import one_rank
    from nmf_toolbox_tpu_torch.parallel import make_mesh
    a = tt.cmfwisa_encode(Vs, Ws, maxiter=3, **CPU)
    with one_rank():
        b = tt.cmfwisa_encode(Vs, Ws, maxiter=3, mesh=make_mesh(1, device_type="cpu"))
    for s in range(len(Ws)):
        assert torch.equal(a.H[s], b.H[s]) and torch.equal(a.P[s], b.P[s])
