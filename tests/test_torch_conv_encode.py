"""Port's convolutive encode engines (``cnmf_encode``, ``nmf2d_encode``)
against the JAX package's and against the port's own single solvers.

Both packages get the same NumPy inputs and injected inits and run in f64
on the CPU: H within rtol 1e-9 of its largest entry, the (B, iters) cost
traces within rtol 1e-9.  Per problem an encode is the single solver with
the dictionary fixed (``cnmf(..., W_init=W, W_fixed=True)``, ``nmf2d``
likewise).  One small shape serves every case, so the JAX side compiles
few programs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False

import nmf_toolbox_tpu as jt  # noqa: E402
import nmf_toolbox_tpu_torch as tt  # noqa: E402
from nmf_toolbox_tpu_torch.interop import factors_from_numpy  # noqa: E402

RTOL = 1e-9
CPU = {"device": "cpu"}  # the port runs arrays on the card unless told
B, M, N, K, T, P, ITERS = 3, 12, 18, 3, 3, 3, 10


def np_(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def close(a, b, rtol=RTOL):
    a, b = np_(a), np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * np.max(np.abs(b)))


def assert_parity(t, j):
    for name in ("W", "H"):
        tv, jv = getattr(t, name), getattr(j, name)
        tv, jv = (tv, jv) if isinstance(jv, list) else ([tv], [jv])
        assert len(tv) == len(jv)
        for a, b in zip(tv, jv):
            assert torch.is_tensor(a) and a.device.type == "cpu"
            close(a, b)
    assert isinstance(t.cost, np.ndarray) and t.cost.shape == np.shape(j.cost)
    np.testing.assert_allclose(t.cost, np.asarray(j.cost), rtol=RTOL, atol=0)
    assert (t.n_iters, t.converged) == (j.n_iters, j.converged)


def problem(seed=0):
    """Vs (B, M, N), an unnormalized dictionary W (M, K, T), H inits for
    cnmf_encode (B, K, N) and nmf2d_encode (B, K, N, P)."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.1, 1.0, (B, M, N)), rng.uniform(0.1, 1.0, (M, K, T)),
            rng.uniform(size=(B, K, N)), rng.uniform(size=(B, K, N, P)))


def _mask(shape, seed):
    return (np.random.default_rng(seed).uniform(size=shape) < 0.8).astype(float)


# ---------------------------------------------------------------------------
# Cross-package parity in f64
# ---------------------------------------------------------------------------

CNMF_ENCODE = {
    "euclidean": {},
    "kl": {"divergence": "kl"},
    "is": {"divergence": "is"},
    "ab": {"divergence": "ab", "alpha": 0.5, "beta": 1.5},
    # the dual's cost is +inf by the reference's 1/(alpha*beta) and its H
    # grows fast: three iterations
    "ab_dual": {"divergence": "ab", "alpha": 0.0, "beta": 2.0, "maxiter": 3},
    "sparsity": {"H_sparsity": 0.2},
    "weights_shared_kl": {"divergence": "kl", "weights": _mask((M, N), 1)},
    "weights_batched_euclidean": {"weights": _mask((B, M, N), 2)},
    "weights_batched_is": {"divergence": "is", "weights": _mask((B, M, N), 3)},
    "cost_every_kl": {"divergence": "kl", "cost_every": 3},
}


@pytest.mark.parametrize("case", sorted(CNMF_ENCODE))
def test_cnmf_encode_parity_with_jax(case):
    Vs, W, H0, _ = problem(1)
    kw = {"H_init": H0, "maxiter": ITERS, **CNMF_ENCODE[case]}
    t = tt.cnmf_encode(Vs, W, **kw, **CPU)
    assert t.W.shape == (M, K, T) and t.H.shape == (B, K, N)
    assert_parity(t, jt.cnmf_encode(Vs, W, dtype=np.float64, **kw))


def test_cnmf_encode_multi_source_parity():
    """A LIST of dictionaries sharing T concatenates along the basis axis,
    with per-source H_sparsity; W and H come back per source."""
    Vs, W, H0, _ = problem(2)
    kw = dict(H_init=[H0[:, :2], H0[:, 2:]], H_sparsity=[0.0, 0.3], divergence="kl",
              maxiter=ITERS)
    Ws = [W[:, :2], W[:, 2:]]
    t = tt.cnmf_encode(Vs, Ws, **kw, **CPU)
    assert [h.shape for h in t.H] == [(B, 2, N), (B, 1, N)]
    assert_parity(t, jt.cnmf_encode(Vs, Ws, dtype=np.float64, **kw))


NMF2D_ENCODE = {
    "euclidean": {},
    "kl": {"divergence": "kl"},
    "is": {"divergence": "is"},
    "ab": {"divergence": "ab", "alpha": 0.5, "beta": 1.5},
    "sparsity": {"H_sparsity": 0.3},
    "cost_every_euclidean": {"cost_every": 4},
}


@pytest.mark.parametrize("case", sorted(NMF2D_ENCODE))
def test_nmf2d_encode_parity_with_jax(case):
    Vs, W, _, H3 = problem(3)
    kw = {"H_init": H3, "maxiter": ITERS, **NMF2D_ENCODE[case]}
    t = tt.nmf2d_encode(Vs, W, P, **kw, **CPU)
    assert t.W.shape == (M, K, T) and t.H.shape == (B, K, N, P)
    assert_parity(t, jt.nmf2d_encode(Vs, W, P, dtype=np.float64, **kw))


def test_jax_trained_dictionary_encodes_alike():
    """Serving across packages: a dictionary the JAX package's cnmf
    trained, carried over by interop.factors_from_numpy, encodes as JAX
    encodes."""
    Vs, W, H0, _ = problem(4)
    trained = jt.cnmf(Vs[0], K, T, W_init=W, H_init=H0[0], divergence="kl",
                      maxiter=ITERS, dtype=np.float64)
    Wt, = factors_from_numpy(trained, fields=("W",), **CPU)
    kw = dict(H_init=H0, divergence="kl", maxiter=ITERS)
    assert_parity(tt.cnmf_encode(Vs, Wt, **kw, **CPU),
                  jt.cnmf_encode(Vs, trained.W, dtype=np.float64, **kw))


# ---------------------------------------------------------------------------
# Against the port's own single solvers (the chip smoke's check)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("div", ["euclidean", "kl", "is"])
def test_encoders_match_single_solvers_with_w_fixed(div):
    Vs, W, H0, H3 = problem(5)
    one = dict(W_init=W, W_fixed=True, maxiter=ITERS, tolerance=1e-30, divergence=div,
               **CPU)
    enc = tt.cnmf_encode(Vs, W, H_init=H0, divergence=div, maxiter=ITERS, **CPU)
    enc2 = tt.nmf2d_encode(Vs, W, P, H_init=H3, divergence=div, maxiter=ITERS, **CPU)
    for b in (0, B - 1):
        ref = tt.cnmf(Vs[b], K, T, H_init=H0[b], **one)
        close(enc.W, np_(ref.W), rtol=1e-12)
        close(enc.H[b], np_(ref.H), rtol=1e-12)
        np.testing.assert_allclose(enc.cost[b], ref.cost, rtol=1e-12)
        ref = tt.nmf2d(Vs[b], K, T, P, H_init=H3[b], **one)
        close(enc2.H[b], np_(ref.H), rtol=1e-12)
        np.testing.assert_allclose(enc2.cost[b], ref.cost, rtol=1e-12)


def test_weighted_encode_matches_weighted_cnmf():
    """Per-problem weights use cnmf's shifted weighted fields."""
    Vs, W, H0, _ = problem(6)
    Mw = _mask((B, M, N), 7)
    enc = tt.cnmf_encode(Vs, W, H_init=H0, weights=Mw, divergence="kl",
                         maxiter=ITERS, **CPU)
    for b in (0, B - 1):
        ref = tt.cnmf(Vs[b], K, T, W_init=W, W_fixed=True, H_init=H0[b], weights=Mw[b],
                      divergence="kl", maxiter=ITERS, tolerance=1e-30, **CPU)
        close(enc.H[b], np_(ref.H), rtol=1e-12)
        np.testing.assert_allclose(enc.cost[b], ref.cost, rtol=1e-12)


# ---------------------------------------------------------------------------
# cost_every: H bit-identical, costs computed on checks and carried
# ---------------------------------------------------------------------------

COST_EVERY = {
    "cnmf_euclidean": lambda Vs, W, H0, H3, **kw: tt.cnmf_encode(Vs, W, H_init=H0, **kw),
    "cnmf_kl": lambda Vs, W, H0, H3, **kw: tt.cnmf_encode(Vs, W, H_init=H0,
                                                          divergence="kl", **kw),
    "nmf2d_euclidean": lambda Vs, W, H0, H3, **kw: tt.nmf2d_encode(Vs, W, P, H_init=H3, **kw),
    "nmf2d_kl": lambda Vs, W, H0, H3, **kw: tt.nmf2d_encode(Vs, W, P, H_init=H3,
                                                            divergence="kl", **kw),
}


@pytest.mark.parametrize("case", sorted(COST_EVERY))
def test_cost_every_leaves_h_bit_identical(case):
    Vs, W, H0, H3 = problem(8)
    run = lambda **kw: COST_EVERY[case](Vs, W, H0, H3, maxiter=11, **kw, **CPU)
    r1, r4 = run(), run(cost_every=4)
    assert torch.equal(r1.W, r4.W) and torch.equal(r1.H, r4.H)
    for i in range(11):
        want = r1.cost[:, i] if i in (0, 3, 7, 10) else r4.cost[:, i - 1]
        assert np.array_equal(r4.cost[:, i], want)


# ---------------------------------------------------------------------------
# Defaults, options that change nothing, devices
# ---------------------------------------------------------------------------

def test_default_inits_seeded_and_device_output_ignored():
    Vs, W, *_ = problem(9)
    for run in (lambda **kw: tt.cnmf_encode(Vs, W, maxiter=5, divergence="kl", **kw, **CPU),
                lambda **kw: tt.nmf2d_encode(Vs, W, P, maxiter=5, **kw, **CPU)):
        a, b, c = run(seed=3), run(seed=3, device_output=True), run(seed=4)
        assert torch.equal(a.H, b.H) and np.array_equal(a.cost, b.cost)
        assert not torch.equal(a.H, c.H)
        assert np.all(np.diff(a.cost, axis=1) <= 1e-9 * np.abs(a.cost[:, :-1]))


def test_tensors_stay_on_their_device():
    Vs, W, H0, _ = problem(10)
    r = tt.cnmf_encode(torch.from_numpy(Vs).float(), torch.from_numpy(W).float(),
                       H_init=H0, maxiter=3)
    assert r.H.device.type == "cpu" and r.H.dtype == torch.float32
    assert r.cost.dtype == np.float32 and r.cost.shape == (B, 3)


# ---------------------------------------------------------------------------
# Validators: the JAX package's errors
# ---------------------------------------------------------------------------

VS, WD, _, _ = problem(11)
VALIDATION = {
    "cnmf_2d_vs": ("cnmf_encode", (VS[0], WD), {}, "B, m, n"),
    "cnmf_2d_w": ("cnmf_encode", (VS, WD[:, :, 0]), {}, r"\(m, k, T\)"),
    "cnmf_t_mismatch": ("cnmf_encode", (VS, [WD, WD[:, :, :2]]), {}, "context length"),
    "cnmf_w_fixed": ("cnmf_encode", (VS, WD), {"W_fixed": True}, "W_fixed"),
    "cnmf_w_init": ("cnmf_encode", (VS, WD), {"W_init": WD}, "does not apply"),
    "cnmf_h_fixed": ("cnmf_encode", (VS, WD), {"H_fixed": True}, "does not apply"),
    "cnmf_inner": ("cnmf_encode", (VS, WD), {"inner_iters": 2}, "does not apply"),
    "cnmf_data_dtype": ("cnmf_encode", (VS, WD), {"data_dtype": "bfloat16"}, "data_dtype"),
    "cnmf_ab_zero": ("cnmf_encode", (VS, WD), {"divergence": "ab", "alpha": 0.0,
                                              "beta": 0.0}, "alpha = 0"),
    "cnmf_h_init": ("cnmf_encode", (VS, WD), {"H_init": np.ones((B, K, N + 1))}, "H_init"),
    "cnmf_h_init_list": ("cnmf_encode", (VS, [WD, WD]), {"H_init": [np.ones((B, K, N))]},
                         "Requested 2 sources"),
    "cnmf_weights_shape": ("cnmf_encode", (VS, WD), {"weights": np.ones((3, 3))},
                           "weights must be"),
    "cnmf_weights_negative": ("cnmf_encode", (VS, WD), {"weights": -np.ones((M, N))},
                              "nonnegative"),
    "nmf2d_2d_vs": ("nmf2d_encode", (VS[0], WD, P), {}, "B, m, n"),
    "nmf2d_2d_w": ("nmf2d_encode", (VS, WD[:, :, 0], P), {}, r"\(m, k, T\)"),
    "nmf2d_pitch_zero": ("nmf2d_encode", (VS, WD, 0), {}, "pitch_len"),
    "nmf2d_pitch_over_m": ("nmf2d_encode", (VS, WD, M + 1), {}, "pitch_len"),
    "nmf2d_weights": ("nmf2d_encode", (VS, WD, P), {"weights": np.ones((M, N))}, "weights"),
    "nmf2d_w_fixed": ("nmf2d_encode", (VS, WD, P), {"W_fixed": True}, "W_fixed"),
    "nmf2d_data_dtype": ("nmf2d_encode", (VS, WD, P), {"data_dtype": "bfloat16"},
                         "data_dtype"),
    "nmf2d_h_init": ("nmf2d_encode", (VS, WD, P), {"H_init": np.ones((B, K, N, P + 1))},
                     "H_init"),
}


@pytest.mark.parametrize("case", sorted(VALIDATION))
def test_validators_raise_as_jax(case):
    name, args, cfg, match = VALIDATION[case]
    with pytest.raises(ValueError, match=match):
        getattr(jt, name)(*args, maxiter=2, **cfg)
    with pytest.raises(ValueError, match=match):
        getattr(tt, name)(*args, maxiter=2, **cfg, **CPU)


ENGINES = {
    "cnmf_encode": lambda **kw: tt.cnmf_encode(VS, WD, maxiter=2, **kw),
    "nmf2d_encode": lambda **kw: tt.nmf2d_encode(VS, WD, P, maxiter=2, **kw),
}


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_mesh_not_ported(name):
    """A foreign mesh= raises a TypeError naming make_mesh; a one-rank
    mesh gives the unmeshed result bit for bit (the sharded cases are
    tests/test_torch_parallel.py's)."""
    with pytest.raises(TypeError, match="make_mesh"):
        ENGINES[name](mesh=object(), **CPU)
    from torch_mesh import one_rank
    from nmf_toolbox_tpu_torch.parallel import make_mesh
    a = ENGINES[name](**CPU)
    with one_rank():
        b = ENGINES[name](mesh=make_mesh(1, device_type="cpu"))
    assert torch.equal(a.H, b.H)
    np.testing.assert_array_equal(a.cost, b.cost)


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_arrays_default_to_the_card_and_raise_without_one(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ENGINES[name]()
