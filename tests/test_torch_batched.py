"""Port's batched engines (nmf_toolbox_tpu_torch.models.batched) against
the JAX package's.

Both sides get the same NumPy inputs and injected inits (the packages'
seeded default inits draw different numbers) and run in f64 on the CPU:
factors agree to atol 1e-9 and cost traces to rtol 1e-9, the JAX
package's own pins for these engines (tests/test_batched.py).  One small
shape serves every case, so the JAX side compiles few programs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import nmf_toolbox_tpu as jt  # noqa: E402
import nmf_toolbox_tpu_torch as tt  # noqa: E402
from nmf_toolbox_tpu_torch.interop import factors_from_numpy  # noqa: E402
from nmf_toolbox_tpu_torch.models import batched as tb  # noqa: E402

ATOL = 1e-9   # f64 factors (tests/test_batched.py's pin)
RTOL = 1e-9   # f64 cost traces
CPU = {"device": "cpu"}  # the port runs arrays on the card unless told
B, M, N, K, ITERS = 3, 12, 15, 3, 10


def np_(x):
    return [np_(a) for a in x] if isinstance(x, list) else x.detach().cpu().numpy()


def problem(seed=0, b=B, m=M, n=N, k=K):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.1, 1.0, (b, m, n)), rng.uniform(size=(b, m, k)),
            rng.uniform(size=(b, k, n)))


def assert_parity(t, j, fields=("W", "H")):
    for name in fields:
        tv, jv = getattr(t, name), getattr(j, name)
        if isinstance(jv, list):
            assert isinstance(tv, list) and len(tv) == len(jv)
        else:
            tv, jv = [tv], [jv]
        for a, b in zip(tv, jv):
            assert torch.is_tensor(a) and a.device.type == "cpu"
            np.testing.assert_allclose(np_(a), np.asarray(b), atol=ATOL, rtol=0)
    assert isinstance(t.cost, np.ndarray) and t.cost.shape == np.shape(j.cost)
    np.testing.assert_allclose(t.cost, np.asarray(j.cost), rtol=RTOL, atol=0)
    assert (t.n_iters, t.converged) == (j.n_iters, j.converged)


# ---------------------------------------------------------------------------
# Cross-package parity in f64
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("div,extra", [
    ("euclidean", {}), ("kl", {}), ("euclidean", {"inner_iters": 3}),
])
def test_batched_parity(div, extra):
    Vs, W0, H0 = problem(1)
    kw = dict(W_init=W0, H_init=H0, divergence=div, maxiter=ITERS, **extra)
    t = tt.nmf_batched(Vs, K, **kw, **CPU)
    assert t.W.shape == (B, M, K) and t.cost.shape == (B, ITERS)
    assert_parity(t, jt.nmf_batched(Vs, K, dtype=np.float64, **kw))


@pytest.mark.parametrize("div,extra", [
    ("euclidean", {}), ("kl", {}), ("euclidean", {"inner_iters": 3}),
])
def test_multiseed_parity(div, extra):
    Vs, W0, H0 = problem(2)
    kw = dict(W_init=W0, H_init=H0, divergence=div, maxiter=ITERS, **extra)
    t = tt.nmf_multiseed(Vs[0], K, B, **kw, **CPU)
    assert t.W.shape == (B, M, K) and t.H.shape == (B, K, N)
    assert_parity(t, jt.nmf_multiseed(Vs[0], K, B, dtype=np.float64, **kw))


def _mask(shape, seed):
    return (np.random.default_rng(seed).uniform(size=shape) < 0.8).astype(float)


ENCODE_CASES = {
    "euclidean": {},
    "kl": {"divergence": "kl"},
    "is": {"divergence": "is"},
    "ab": {"divergence": "ab", "alpha": 0.5, "beta": 1.5},
    # The dual's H grows ~100x per iteration on this data (its cost is
    # +inf by the reference's 1/(alpha*beta)), so three iterations keep
    # the factors where an absolute tolerance means something.
    "ab_dual": {"divergence": "ab", "alpha": 0.0, "beta": 2.0, "maxiter": 3},
    "sparsity": {"H_sparsity": 0.3},
    "weights_shared_kl": {"divergence": "kl", "weights": _mask((M, N), 3)},
    "weights_batched_euclidean": {"weights": _mask((B, M, N), 4)},
}


@pytest.mark.parametrize("case", sorted(ENCODE_CASES))
def test_encode_parity(case):
    Vs, _, H0 = problem(5)
    W = np.random.default_rng(6).uniform(size=(M, K))
    kw = {"H_init": H0, "maxiter": ITERS, **ENCODE_CASES[case]}
    t = tt.nmf_encode(Vs, W, **kw, **CPU)
    assert t.W.shape == (M, K) and t.H.shape == (B, K, N)
    assert_parity(t, jt.nmf_encode(Vs, W, dtype=np.float64, **kw))


def test_encode_multi_source_parity():
    """A LIST of dictionaries concatenates along the basis axis and
    returns per-source W/H lists, with per-source H_sparsity."""
    Vs, _, H0 = problem(7, k=5)
    rng = np.random.default_rng(8)
    WA, WB = rng.uniform(size=(M, 3)), rng.uniform(size=(M, 2))
    kw = dict(H_init=[H0[:, :3], H0[:, 3:]], H_sparsity=[0.0, 0.2],
              divergence="kl", maxiter=ITERS)
    t = tt.nmf_encode(Vs, [WA, WB], **kw, **CPU)
    assert [h.shape for h in t.H] == [(B, 3, N), (B, 2, N)]
    assert_parity(t, jt.nmf_encode(Vs, [WA, WB], dtype=np.float64, **kw))


def test_jax_trained_dictionary_encodes_alike():
    """Serving across packages: a dictionary the JAX package's nmf trained,
    carried over by interop.factors_from_numpy, encodes as JAX encodes."""
    Vs, _, H0 = problem(9)
    rng = np.random.default_rng(10)
    trained = jt.nmf(Vs[0], K, W_init=rng.uniform(size=(M, K)),
                     H_init=rng.uniform(size=(K, N)), divergence="kl",
                     maxiter=ITERS, dtype=np.float64)
    W, _ = factors_from_numpy(trained, **CPU)
    kw = dict(H_init=H0, divergence="kl", maxiter=ITERS)
    t = tt.nmf_encode(Vs, W, **kw, **CPU)
    assert_parity(t, jt.nmf_encode(Vs, trained.W, dtype=np.float64, **kw))


# ---------------------------------------------------------------------------
# Against the port's own single-problem solver (the chip smoke's check)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("div", ["euclidean", "kl"])
def test_engines_match_single_solver(div):
    Vs, W0, H0 = problem(11)
    one = dict(maxiter=ITERS, tolerance=1e-30, divergence=div, **CPU)
    bat = tt.nmf_batched(Vs, K, W_init=W0, H_init=H0, divergence=div,
                         maxiter=ITERS, **CPU)
    enc = tt.nmf_encode(Vs, W0[0], H_init=H0, divergence=div, maxiter=ITERS, **CPU)
    for b in (0, B - 1):
        ref = tt.nmf(Vs[b], K, W_init=W0[b], H_init=H0[b], **one)
        np.testing.assert_allclose(np_(bat.W[b]), np_(ref.W), atol=1e-12)
        np.testing.assert_allclose(bat.cost[b], ref.cost, rtol=1e-12)
        ref = tt.nmf(Vs[b], K, W_init=W0[0], H_init=H0[b], W_fixed=True, **one)
        np.testing.assert_allclose(np_(enc.H[b]), np_(ref.H), atol=1e-12)
        np.testing.assert_allclose(enc.cost[b], ref.cost, rtol=1e-12)


# ---------------------------------------------------------------------------
# cost_every: factors bit-identical, costs computed on checks and carried
# ---------------------------------------------------------------------------

COST_EVERY = {
    "batched_euclidean": ("batched", {}),
    "batched_kl": ("batched", {"divergence": "kl"}),
    "encode_euclidean": ("encode", {"H_sparsity": 0.05}),
    "encode_kl": ("encode", {"divergence": "kl"}),
    "encode_is": ("encode", {"divergence": "is"}),
    "encode_weighted_kl": ("encode", {"divergence": "kl", "weights": _mask((B, M, N), 12)}),
}


@pytest.mark.parametrize("case", sorted(COST_EVERY))
def test_cost_every_leaves_factors_bit_identical(case):
    """After tests/test_cost_every.py:145-200: the objective is computed at
    iterations 0, 3, 7 and the last (cost_every=4) and carried between."""
    engine, extra = COST_EVERY[case]
    Vs, W0, H0 = problem(13)
    if engine == "batched":
        run = lambda **kw: tt.nmf_batched(Vs, K, W_init=W0, H_init=H0, maxiter=11,
                                          **extra, **kw, **CPU)
    else:
        run = lambda **kw: tt.nmf_encode(Vs, W0[0], H_init=H0, maxiter=11,
                                         **extra, **kw, **CPU)
    r1, r4 = run(), run(cost_every=4)
    assert torch.equal(r1.W, r4.W) and torch.equal(r1.H, r4.H)
    for i in range(11):
        want = r1.cost[:, i] if i in (0, 3, 7, 10) else r4.cost[:, i - 1]
        assert np.array_equal(r4.cost[:, i], want)


def test_cost_every_trace_matches_jax():
    Vs, _, H0 = problem(14)
    W = np.random.default_rng(15).uniform(size=(M, K))
    kw = dict(H_init=H0, divergence="kl", maxiter=ITERS, cost_every=3)
    assert_parity(tt.nmf_encode(Vs, W, **kw, **CPU),
                  jt.nmf_encode(Vs, W, dtype=np.float64, **kw))


# ---------------------------------------------------------------------------
# Storage dtype, defaults, options that change nothing
# ---------------------------------------------------------------------------

def test_bf16_storage_tracks_f32():
    rng = np.random.default_rng(16)
    Vs = rng.random((2, 24, 32)).astype(np.float32)
    W0 = rng.random((2, 24, 4)).astype(np.float32)
    H0 = rng.random((2, 4, 32)).astype(np.float32)
    kw = dict(W_init=W0, H_init=H0, maxiter=15, **CPU)
    a = tt.nmf_batched(Vs, 4, **kw)
    b = tt.nmf_batched(Vs, 4, data_dtype="bfloat16", **kw)
    assert b.W.dtype == torch.float32 and b.cost.dtype == np.float32
    np.testing.assert_allclose(b.cost[:, -1], a.cost[:, -1], rtol=1e-2)
    e = tt.nmf_encode(Vs, W0[0], H_init=H0, data_dtype="bfloat16", maxiter=15, **CPU)
    f = tt.nmf_encode(Vs, W0[0], H_init=H0, maxiter=15, **CPU)
    np.testing.assert_allclose(e.cost[:, -1], f.cost[:, -1], rtol=1e-2)
    s = tt.nmf_multiseed(Vs[0], 4, 2, W_init=W0, H_init=H0, maxiter=15,
                         data_dtype="bfloat16", **CPU)
    assert s.W.dtype == torch.float32 and np.all(np.isfinite(s.cost))


def test_default_inits_seeded_and_monotone():
    Vs = np.random.default_rng(17).uniform(0.1, 1, (3, 12, 16)).astype(np.float32)
    a, b = (tt.nmf_batched(Vs, 2, maxiter=10, seed=4, **CPU) for _ in range(2))
    c = tt.nmf_batched(Vs, 2, maxiter=10, seed=5, **CPU)
    assert torch.equal(a.W, b.W) and not torch.equal(a.W, c.W)
    assert np.all(np.diff(a.cost, axis=1) <= 1e-3 * np.abs(a.cost[:, :-1]))
    e = tt.nmf_encode(Vs, np.abs(np.asarray(a.W[0])), maxiter=8, seed=3, **CPU)
    assert np.all(np.diff(e.cost, axis=1) <= 1e-4 * np.abs(e.cost[:, :-1]))
    s = tt.nmf_multiseed(Vs[0], 3, 4, maxiter=5, seed=7, **CPU)
    assert len(np.unique(np.round(s.cost[:, -1], 6))) > 1
    assert s.final_cost == float(np.min(s.cost[:, -1]))


def test_device_output_changes_nothing():
    Vs, W0, H0 = problem(18)
    kw = dict(W_init=W0, H_init=H0, maxiter=5, **CPU)
    a = tt.nmf_batched(Vs, K, **kw)
    b = tt.nmf_batched(Vs, K, device_output=True, **kw)
    assert torch.equal(a.W, b.W) and torch.equal(a.H, b.H)
    assert np.array_equal(a.cost, b.cost)


def test_tensors_stay_on_their_device():
    Vs, W0, H0 = problem(19)
    r = tt.nmf_encode(torch.from_numpy(Vs).float(), torch.from_numpy(W0[0]),
                      H_init=H0, maxiter=3)
    assert r.H.device.type == "cpu" and r.H.dtype == torch.float32
    assert r.cost.dtype == np.float32 and r.cost.shape == (B, 3)


# ---------------------------------------------------------------------------
# Validators: the JAX package's errors
# ---------------------------------------------------------------------------

def _bad(rng=np.random.default_rng(20)):
    Vs = rng.uniform(0.1, 1, (2, 8, 10))
    W = rng.uniform(size=(8, 2))
    return Vs, W


VS, WD = _bad()
VALIDATION = {
    "batched_2d": ("nmf_batched", (VS[0], 2), {}, "B, m, n"),
    "batched_is": ("nmf_batched", (VS, 2), {"divergence": "is"}, "euclidean.*or.*kl"),
    "batched_kl_inner": ("nmf_batched", (VS, 2), {"divergence": "kl", "inner_iters": 2},
                         "euclidean"),
    "batched_kl_bf16": ("nmf_batched", (VS, 2), {"divergence": "kl",
                                                 "data_dtype": "bfloat16"}, "data_dtype"),
    "encode_2d": ("nmf_encode", (VS[0], WD), {}, "B, m, n"),
    "encode_wrong_w": ("nmf_encode", (VS, WD.T), {}, r"\(m, k\)"),
    "encode_w_fixed": ("nmf_encode", (VS, WD), {"W_fixed": True}, "W_fixed"),
    "encode_h_fixed": ("nmf_encode", (VS, WD), {"H_fixed": True}, "does not apply"),
    "encode_inner": ("nmf_encode", (VS, WD), {"inner_iters": 3}, "does not apply"),
    "encode_w_sparsity": ("nmf_encode", (VS, WD), {"W_sparsity": 0.1}, "does not apply"),
    "encode_ab_zero": ("nmf_encode", (VS, WD), {"divergence": "ab", "alpha": 0.0,
                                                "beta": 0.0}, "alpha = 0"),
    "encode_h_init": ("nmf_encode", (VS, WD), {"H_init": np.ones((2, 3, 10))}, "H_init"),
    "encode_h_init_list": ("nmf_encode", (VS, [WD, WD]), {"H_init": [np.ones((2, 2, 10))]},
                           "Requested 2 sources"),
    "encode_weights_negative": ("nmf_encode", (VS, WD), {"weights": -np.ones((8, 10))},
                                "nonnegative"),
    "encode_weights_shape": ("nmf_encode", (VS, WD), {"weights": np.ones((3, 3))},
                             "weights must be"),
    "encode_weights_bf16": ("nmf_encode", (VS, WD), {"weights": np.ones((8, 10)),
                                                     "data_dtype": "bfloat16"}, "data_dtype"),
    "encode_kl_bf16": ("nmf_encode", (VS, WD), {"divergence": "kl",
                                                "data_dtype": "bfloat16"}, "data_dtype"),
    "multiseed_seed_axis": ("nmf_multiseed", (VS[0], 3, 4), {"W_init": np.ones((8, 3))},
                            "leading seed axis"),
    "multiseed_zero_seeds": ("nmf_multiseed", (VS[0], 3, 0), {}, "n_seeds"),
    "multiseed_3d": ("nmf_multiseed", (VS, 2, 2), {}, "expects"),
    "multiseed_is": ("nmf_multiseed", (VS[0], 2, 2), {"divergence": "is"},
                     "euclidean.*or.*kl"),
    "multiseed_inner_kl": ("nmf_multiseed", (VS[0], 2, 2), {"divergence": "kl",
                                                            "inner_iters": 2}, "euclidean"),
}


@pytest.mark.parametrize("case", sorted(VALIDATION))
def test_validators_raise_as_jax(case):
    name, args, cfg, match = VALIDATION[case]
    with pytest.raises(ValueError, match=match):
        getattr(jt, name)(*args, maxiter=2, **cfg)
    with pytest.raises(ValueError, match=match):
        getattr(tt, name)(*args, maxiter=2, **cfg, **CPU)


ENGINES = {
    "nmf_batched": lambda **kw: tt.nmf_batched(VS, 2, maxiter=2, **kw),
    "nmf_encode": lambda **kw: tt.nmf_encode(VS, WD, maxiter=2, **kw),
    "nmf_multiseed": lambda **kw: tt.nmf_multiseed(VS[0], 2, 2, maxiter=2, **kw),
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


def test_inner_solve_reads_costs_only_on_checks():
    """The engines' loop evaluates the objective on check iterations alone
    and returns the trace as one device tensor."""
    calls = []

    def step(state):
        new = state + 1
        return new, lambda: calls.append(int(new[0])) or new.double()

    state, costs = tb._scan(step, torch.zeros(2), 11, 4, torch.float64)
    assert calls == [1, 4, 8, 11] and torch.is_tensor(costs)
    assert costs[0].tolist() == [1, 1, 1, 4, 4, 4, 4, 8, 8, 8, 11]
