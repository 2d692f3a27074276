"""Port's convolutive family (ops/shift.py, cnmf, nmf2d, chcnmf) against
the JAX package, tests/oracle.py and the stored goldens.

Both sides get the same NumPy inputs and injected inits (the packages'
seeded default inits draw different numbers) and run in f64 on the CPU:
factors agree within rtol 1e-9 of their largest entry and cost traces
within rtol 1e-9, with n_iters and converged equal.  One shape per solver
(T >= 3, k > 1, a random non-symmetric H) keeps the JAX side to few
compiles and pins the (t, k) order of the flattened shift stacks.
"""
import importlib
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import nmf_toolbox_tpu as jt  # noqa: E402
import nmf_toolbox_tpu_torch as tt  # noqa: E402
from nmf_toolbox_tpu.ops import shift as jshift  # noqa: E402
from nmf_toolbox_tpu_torch.interop import factors_from_numpy  # noqa: E402
from nmf_toolbox_tpu_torch.ops import shift as tshift  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).parent))
import oracle  # noqa: E402

jchc = importlib.import_module("nmf_toolbox_tpu.models.chcnmf")
tchc = importlib.import_module("nmf_toolbox_tpu_torch.models.chcnmf")
GOLD = pathlib.Path(__file__).parent / "goldens"
RTOL = 1e-9  # f64 factors (of their largest entry) and cost traces
CPU = {"device": "cpu"}  # the port runs arrays on the card unless told
M, N, K, T, P = 14, 24, 3, 4, 3


def np_(x):
    if isinstance(x, list):
        return [np_(a) for a in x]
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def close(a, b, rtol=RTOL, name=""):
    a, b = np_(a), np.asarray(b)
    assert a.shape == b.shape, name
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * np.max(np.abs(b)), err_msg=name)


def assert_parity(t, j, fields=("W", "H")):
    for name in fields:
        tv, jv = getattr(t, name), getattr(j, name)
        if isinstance(jv, list):
            assert isinstance(tv, list) and len(tv) == len(jv), name
        else:
            tv, jv = [tv], [jv]
        for a, b in zip(tv, jv):
            assert torch.is_tensor(a) and a.device.type == "cpu", name
            close(a, b, name=name)
    assert isinstance(t.cost, np.ndarray) and t.cost.shape == np.shape(j.cost)
    np.testing.assert_allclose(t.cost, np.asarray(j.cost), rtol=RTOL, atol=0)
    assert (t.n_iters, t.converged) == (j.n_iters, j.converged)


def data(seed=0, scale=1.0):
    """V, W0 (M, K, T), H0 (K, N), a pitch H0 (K, N, P) and a weight mask."""
    rng = np.random.default_rng(seed)
    return (scale * rng.uniform(0.1, 1.0, (M, N)), rng.uniform(size=(M, K, T)),
            rng.uniform(size=(K, N)), rng.uniform(size=(K, N, P)),
            (rng.uniform(size=(M, N)) < 0.8).astype(float))


# ---------------------------------------------------------------------------
# The shift operators
# ---------------------------------------------------------------------------

RNG = np.random.default_rng(1)
W3, H2, PHI, H3 = (RNG.uniform(size=s) for s in ((M, K, T), (K, N), (M, N), (K, N, P)))
HB = RNG.uniform(size=(2, K, N))  # a batch of H, as the encoders pass it
SHIFT_OPS = {
    "shift_right": (lambda s, x: s.shift_right(x, 3), (H2,)),
    "shift_right_past_n": (lambda s, x: s.shift_right(x, N + 2), (H2,)),
    "shift_left": (lambda s, x: s.shift_left(x, 2), (PHI,)),
    "shift_down_rows": (lambda s, x: s.shift_down_rows(x, 2), (PHI,)),
    "shift_up_rows": (lambda s, x: s.shift_up_rows(x, 2), (PHI,)),
    "stack_shifts_right": (lambda s, x: s.stack_shifts_right(x, T), (H2,)),
    "conv_reconstruct": (lambda s, w, h: s.conv_reconstruct(w, h), (W3, H2)),
    "conv_wt_phi": (lambda s, w, phi: s.conv_wt_phi(w, phi), (W3, PHI)),
    "conv_phi_ht": (lambda s, phi, h: s.conv_phi_ht(phi, h, T), (PHI, H2)),
    "conv_reconstruct_2d": (lambda s, w, h: s.conv_reconstruct_2d(w, h), (W3, H3)),
}


@pytest.mark.parametrize("name", sorted(SHIFT_OPS))
def test_shift_op_matches_jax(name):
    fn, args = SHIFT_OPS[name]
    got = fn(tshift, *(torch.from_numpy(a) for a in args))
    close(got, fn(jshift, *(jnp.asarray(a) for a in args)), name=name)


def test_nmf2d_gradients_match_the_per_pitch_forms():
    """conv_wt_phi_2d and conv_phi_ht_2d (one GEMM over P*T*k each) against
    models/nmf2d.py's per-pitch einsums."""
    tw = tshift.conv_wt_phi_2d(torch.from_numpy(W3), torch.from_numpy(PHI), P)
    jw = np.stack([np.asarray(jshift.conv_wt_phi(W3, jshift.shift_up_rows(PHI, p)))
                   for p in range(P)], axis=2)
    close(tw, jw)
    ta = tshift.conv_phi_ht_2d(torch.from_numpy(PHI), torch.from_numpy(H3), T)
    ja = sum(np.einsum("mn,tkn->mkt", np.asarray(jshift.shift_up_rows(PHI, p)),
                       np.asarray(jshift.stack_shifts_right(H3[:, :, p], T)))
             for p in range(P))
    close(ta, ja)


def test_operators_broadcast_over_a_batch_of_h():
    w, hb = torch.from_numpy(W3), torch.from_numpy(HB)
    got = tshift.conv_reconstruct(w, hb)
    for b in range(2):
        close(got[b], oracle.reconstruct(W3, HB[b]))
        close(tshift.conv_wt_phi(w, got)[b], jshift.conv_wt_phi(W3, np_(got[b])))


def test_flattened_frames_pin_the_t_k_order():
    """The flat basis (m, T*k) and the flat shift stack (T*k, n) agree on
    the (t, k) order: a literal double loop over t and k."""
    Wf = tshift.flatten_frames(torch.from_numpy(W3))
    Hs = tshift.stack_shifts_right(torch.from_numpy(H2), T).flatten(0, 1)
    want = np.zeros((M, N))
    for t in range(T):
        for k in range(K):
            want += np.outer(W3[:, k, t], np.concatenate([np.zeros(t), H2[k, : N - t]]))
    close(Wf @ Hs, want)
    close(tshift.unflatten_frames(Wf, T), W3)


RECON = {
    "2d_basis": (W3[:, :, 0], H2),
    "convolutive": (W3, H2),
    "pitch_h": (W3, H3),
    "source_lists": ([W3[:, :1], W3[:, 1:]], [H2[:1], H2[1:]]),
}


@pytest.mark.parametrize("case", sorted(RECON))
def test_reconstruct_matches_jax_and_oracle(case):
    W, H = RECON[case]
    got = tt.reconstruct(W, H, **CPU)
    assert got.device.type == "cpu" and got.dtype == torch.float64
    close(got, jt.reconstruct(W, H))
    if case != "pitch_h":
        close(got, oracle.reconstruct(W, H))


def test_reconstruct_keeps_tensors_on_their_device():
    got = tt.reconstruct_from_decomposition(torch.from_numpy(W3).float(),
                                            torch.from_numpy(H2).float())
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    close(got, oracle.reconstruct(W3, H2), rtol=1e-6)


# ---------------------------------------------------------------------------
# cnmf against the JAX package
# ---------------------------------------------------------------------------

# (config, data scale); the runs named for their stop rule are checked to
# stop by it.
CNMF = {
    "euclid_gram": ({"method": "gram"}, 1.0),
    "euclid_naive": ({"method": "naive"}, 1.0),
    "kl": ({"divergence": "kl"}, 1.0),
    "is": ({"divergence": "is"}, 1.0),
    "ab": ({"divergence": "ab", "alpha": 0.5, "beta": 1.5}, 1.0),
    # the dual's factors grow fast and its cost is +inf by the reference's
    # 1/(alpha*beta): three iterations keep the comparison meaningful
    "ab_dual": ({"divergence": "ab", "alpha": 0.0, "beta": 2.0, "maxiter": 3}, 1.0),
    "weighted_euclid": ({"weights": "mask"}, 1.0),
    "weighted_kl": ({"divergence": "kl", "weights": "mask"}, 1.0),
    "weighted_is": ({"divergence": "is", "weights": "mask"}, 1.0),
    "sparsity_gram": ({"W_sparsity": 0.1, "H_sparsity": 0.2}, 1.0),
    "sparsity_kl": ({"divergence": "kl", "W_sparsity": 0.1, "H_sparsity": 0.2}, 1.0),
    "w_fixed_gram": ({"W_fixed": True}, 1.0),
    "w_fixed_kl": ({"divergence": "kl", "W_fixed": True}, 1.0),
    "h_fixed_gram": ({"H_fixed": True}, 1.0),
    "h_fixed_is": ({"divergence": "is", "H_fixed": True}, 1.0),
    "stops_gram": ({"tolerance": 1e-3, "maxiter": 40}, 0.1),
    "stops_kl": ({"divergence": "kl", "tolerance": 1e-3, "maxiter": 40}, 0.1),
    "cost_every_gram": ({"cost_every": 4}, 1.0),
    "cost_every_kl_stops": ({"divergence": "kl", "cost_every": 4, "tolerance": 0.05,
                             "maxiter": 40}, 0.1),
}


def cnmf_kw(case):
    cfg, scale = CNMF[case]
    V, W0, H0, _, mask = data(1, scale)
    kw = {"W_init": W0, "H_init": H0, "maxiter": 12, "tolerance": 1e-12, **cfg}
    if "weights" in kw:
        kw["weights"] = mask
    return V, kw


@pytest.mark.parametrize("case", sorted(CNMF))
def test_cnmf_parity_with_jax(case):
    V, kw = cnmf_kw(case)
    j = jt.cnmf(V, K, T, dtype=np.float64, **kw)
    t = tt.cnmf(V, K, T, **kw, **CPU)
    assert t.W.shape == (M, K, T) and t.H.shape == (K, N)
    assert_parity(t, j)
    if "stops" in case:
        assert j.converged and j.n_iters < kw["maxiter"]


@pytest.mark.parametrize("div", ["euclidean", "is"])
def test_cnmf_matches_the_oracle(div):
    V, W0, H0, _, _ = data(2)
    t = tt.cnmf(V, K, T, W_init=W0, H_init=H0, divergence=div, maxiter=10,
                tolerance=1e-12, method="naive", **CPU)
    Wo, Ho, co = oracle.cnmf(V, W0, H0, T, divergence=div, maxiter=10, tolerance=1e-12)
    close(t.W, Wo)
    close(t.H, Ho)
    np.testing.assert_allclose(t.cost, co, rtol=RTOL)


def test_gram_step_matches_naive_at_t4():
    """The Gram step's cross-Gram index order: a transposed (t, s) would
    show here (T = 4, random non-symmetric H), not at T = 1."""
    V, W0, H0, _, _ = data(3)
    kw = dict(W_init=W0, H_init=H0, maxiter=10, tolerance=1e-12, **CPU)
    g, n_ = tt.cnmf(V, K, T, method="gram", **kw), tt.cnmf(V, K, T, method="naive", **kw)
    close(g.W, np_(n_.W), rtol=1e-10)
    close(g.H, np_(n_.H), rtol=1e-10)
    np.testing.assert_allclose(g.cost, n_.cost, rtol=1e-10)


@pytest.mark.parametrize("div", ["euclidean", "kl", "is", "ab"])
def test_weights_ones_quirk(div):
    """weights=ones gives the unweighted run for euclidean/IS/AB.  KL's
    unweighted H update keeps the reference's no-shift ones field
    (cnmf.m:220-224): after one iteration it differs from the shifted,
    weighted one in the last T-1 columns of H only."""
    V, W0, H0, _, _ = data(4)
    kw = dict(W_init=W0, H_init=H0, maxiter=1, tolerance=1e-12, divergence=div,
              method="naive", alpha=0.5, beta=1.5, **CPU)
    plain = tt.cnmf(V, K, T, **kw)
    ones = tt.cnmf(V, K, T, weights=np.ones((M, N)), **kw)
    close(ones.W, np_(plain.W), rtol=1e-12)
    if div == "kl":
        edge = N - (T - 1)
        close(ones.H[:, :edge], np_(plain.H)[:, :edge], rtol=1e-12)
        assert np.min(np.abs(np_(ones.H)[:, edge:] - np_(plain.H)[:, edge:])) > 1e-6
    else:
        close(ones.H, np_(plain.H), rtol=1e-12)


def test_kl_quirk_is_the_oracles():
    V, W0, H0, _, _ = data(4)
    t = tt.cnmf(V, K, T, W_init=W0, H_init=H0, divergence="kl", maxiter=8,
                tolerance=1e-12, **CPU)
    Wo, Ho, co = oracle.cnmf(V, W0, H0, T, divergence="kl", maxiter=8, tolerance=1e-12)
    close(t.H, Ho)
    np.testing.assert_allclose(t.cost, co, rtol=RTOL)


def test_cnmf_multi_source_against_jax_and_oracle():
    """Two sources with per-source sparsity and H_fixed on one of them."""
    V, W0, H0, _, _ = data(5)
    kw = dict(W_init=[W0[:, :2], W0[:, 2:]], H_init=[H0[:2], H0[2:]],
              W_sparsity=[0.1, 0.0], H_sparsity=[0.0, 0.2], H_fixed=[False, True],
              maxiter=10, tolerance=1e-12)
    t = tt.cnmf(V, [2, 1], T, **kw, **CPU)
    assert [w.shape for w in t.W] == [(M, 2, T), (M, 1, T)]
    assert_parity(t, jt.cnmf(V, [2, 1], T, dtype=np.float64, **kw))
    Wo, Ho, co = oracle.cnmf_multi(V, kw["W_init"], kw["H_init"], T,
                                   W_sparsity=[0.1, 0.0], H_sparsity=[0.0, 0.2],
                                   H_fixed=[False, True], maxiter=10, tolerance=1e-12)
    for a, b in zip(t.W + t.H, Wo + Ho):
        close(a, b)
    np.testing.assert_allclose(t.cost, co, rtol=RTOL)


# ---------------------------------------------------------------------------
# cost_every: factors bit-identical, costs computed on checks and carried
# ---------------------------------------------------------------------------

def _cnmf(method, div):
    return lambda V, W0, H0, H3, **kw: tt.cnmf(V, K, T, W_init=W0, H_init=H0,
                                              method=method, divergence=div, **kw)


COST_EVERY = {
    "cnmf_gram": _cnmf("gram", "euclidean"),
    "cnmf_naive_euclid": _cnmf("naive", "euclidean"),
    "cnmf_kl": _cnmf("naive", "kl"),
    "nmf2d_kl": lambda V, W0, H0, H3, **kw: tt.nmf2d(V, K, T, P, W_init=W0, H_init=H3,
                                                     divergence="kl", **kw),
}


@pytest.mark.parametrize("case", sorted(COST_EVERY))
def test_cost_every_leaves_factors_bit_identical(case):
    V, W0, H0, H3, _ = data(6)
    run = lambda **kw: COST_EVERY[case](V, W0, H0, H3, maxiter=11, tolerance=1e-30,
                                        **kw, **CPU)
    r1, r4 = run(), run(cost_every=4)
    assert torch.equal(r1.W, r4.W) and torch.equal(r1.H, r4.H)
    for i in range(11):
        want = r1.cost[i] if i in (0, 3, 7, 10) else r4.cost[i - 1]
        assert r4.cost[i] == want


# ---------------------------------------------------------------------------
# nmf2d
# ---------------------------------------------------------------------------

NMF2D = {
    "euclidean": {},
    "kl": {"divergence": "kl"},
    "is": {"divergence": "is"},
    "ab": {"divergence": "ab", "alpha": 0.5, "beta": 1.5},
    "w_fixed_kl": {"divergence": "kl", "W_fixed": True},
    "h_fixed_sparsity": {"H_fixed": True, "W_sparsity": 0.1, "H_sparsity": 0.2},
    "stops": {"tolerance": 1e-3, "maxiter": 40, "scale": 0.1},
    "cost_every": {"cost_every": 3},
}


@pytest.mark.parametrize("case", sorted(NMF2D))
def test_nmf2d_parity_with_jax(case):
    cfg = dict(NMF2D[case])
    V, W0, _, H3, _ = data(1, cfg.pop("scale", 1.0))
    kw = {"W_init": W0, "H_init": H3, "maxiter": 10, "tolerance": 1e-12, **cfg}
    t = tt.nmf2d(V, K, T, P, **kw, **CPU)
    assert t.W.shape == (M, K, T) and t.H.shape == (K, N, P)
    assert_parity(t, jt.nmf2d(V, K, T, P, dtype=np.float64, **kw))
    if case == "stops":
        assert t.converged and t.n_iters < 40


@pytest.mark.parametrize("div", ["euclidean", "is", "kl"])
def test_nmf2d_pitch_len_1_reduces_to_cnmf(div):
    """pitch_len=1 is cnmf's naive step; KL differs only by cnmf's
    no-shift ones field."""
    V, W0, H0, _, _ = data(7)
    kw = dict(W_init=W0, maxiter=8, tolerance=1e-12, divergence=div, **CPU)
    a = tt.nmf2d(V, K, T, 1, H_init=H0[:, :, None], **kw)
    b = tt.cnmf(V, K, T, H_init=H0, method="naive", **kw)
    if div == "kl":
        assert np.max(np.abs(np_(a.H)[:, :, 0] - np_(b.H))) > 1e-6
    else:
        close(a.W, np_(b.W), rtol=1e-12)
        close(a.H[:, :, 0], np_(b.H), rtol=1e-12)
        np.testing.assert_allclose(a.cost, b.cost, rtol=1e-12)


NMF2D_ERRORS = {
    "v_3d": (np.ones((2, M, N)), K, T, P, {}, ValueError, "2-D V"),
    "t_zero": (None, K, 0, P, {}, ValueError, ">= 1"),
    "p_over_m": (None, K, T, M + 1, {}, ValueError, "exceeds"),
    "multi_source": (None, [2, 1], T, P, {}, TypeError, "single-source"),
    "w_init_shape": (None, K, T, P, {"W_init": np.ones((M, K, T + 1))}, ValueError, "W_init"),
    "h_init_shape": (None, K, T, P, {"H_init": np.ones((K, N, P + 1))}, ValueError, "H_init"),
    "ab_zero": (None, K, T, P, {"divergence": "ab", "alpha": 0.0, "beta": 0.0},
                ValueError, "alpha = 0"),
}


@pytest.mark.parametrize("case", sorted(NMF2D_ERRORS))
def test_nmf2d_validation_as_jax(case):
    V, k, t_, p, cfg, exc, match = NMF2D_ERRORS[case]
    V = data(8)[0] if V is None else V
    with pytest.raises(exc, match=match):
        jt.nmf2d(V, k, t_, p, maxiter=2, **cfg)
    with pytest.raises(exc, match=match):
        tt.nmf2d(V, k, t_, p, maxiter=2, **cfg, **CPU)


CNMF_ERRORS = {
    "gram_not_euclid": ({"divergence": "kl", "method": "gram"}, "only valid"),
    "weights_gram": ({"weights": np.ones((M, N)), "method": "gram"}, "naive"),
    "w_init_shape": ({"W_init": np.ones((M, K, T + 1))}, "W_init"),
    "h_init_shape": ({"H_init": np.ones((K, N + 1))}, "H_init"),
    "ab_zero": ({"divergence": "ab", "alpha": 0.0, "beta": 0.0}, "alpha = 0"),
    "weights_negative": ({"weights": -np.ones((M, N))}, "nonnegative"),
}


@pytest.mark.parametrize("case", sorted(CNMF_ERRORS))
def test_cnmf_validation_as_jax(case):
    cfg, match = CNMF_ERRORS[case]
    V = data(8)[0]
    with pytest.raises(ValueError, match=match):
        jt.cnmf(V, K, T, maxiter=2, **cfg)
    with pytest.raises(ValueError, match=match):
        tt.cnmf(V, K, T, maxiter=2, **cfg, **CPU)


# ---------------------------------------------------------------------------
# chcnmf
# ---------------------------------------------------------------------------

def jax_g_draw(p, seed=0):
    """The uniform G JAX's chcnmf draws before fitting it to W_init."""
    kg, _ = jax.random.split(jax.random.PRNGKey(seed))
    return np.array(jax.random.uniform(kg, (p, K, T), jnp.float64))


CHCNMF = {
    "g_init": {},
    "sparsity": {"G_sparsity": 0.1, "H_sparsity": 0.2},
    "g_fixed": {"G_fixed": True},
    "h_fixed": {"H_fixed": True},
    "w_init": {"W_init": True},
    "w_init_w_fixed": {"W_init": True, "W_fixed": True},
    "stops": {"tolerance": 1e-3, "maxiter": 40, "scale": 0.1},
}


@pytest.mark.parametrize("case", sorted(CHCNMF))
def test_chcnmf_parity_with_jax(case, monkeypatch):
    cfg = dict(CHCNMF[case])
    V, W0, H0, _, _ = data(1, cfg.pop("scale", 1.0))
    S = V[:, [1, 4, 7, 9, 13, 20]]
    G0 = np.random.default_rng(9).uniform(size=(S.shape[1], K, T))
    kw = {"S_init": S, "H_init": H0, "maxiter": 10, "tolerance": 1e-12, **cfg}
    if cfg.pop("W_init", False):
        kw["W_init"] = W0
        draw = jax_g_draw(S.shape[1])
        real = tchc.uniform_init
        monkeypatch.setattr(tchc, "uniform_init", lambda gen, shape, *a, **k: (
            torch.from_numpy(draw) if shape == draw.shape else real(gen, shape, *a, **k)))
    else:
        kw["G_init"] = G0
    t = tt.chcnmf(V, K, T, **kw, **CPU)
    j = jt.chcnmf(V, K, T, dtype=np.float64, **kw)
    assert t.G.shape == (S.shape[1], K, T) and len(t.cost) == t.n_iters + 1
    assert_parity(t, j, ("W", "H", "S", "G"))
    if case == "stops":
        assert t.converged and t.n_iters < 40


def test_fit_g_to_w_matches_jax_frame_by_frame():
    """All frames stepped together, each frozen when its own rule fires,
    give the reference's per-frame loops; one frame stops early."""
    rng = np.random.default_rng(10)
    S = rng.uniform(size=(M, 6))
    Wt = np.stack([S @ rng.uniform(size=(6, K)) for _ in range(T)], axis=2)
    Wt[:, :, 1] += 0.5 * rng.uniform(size=(M, K))  # a frame off the hull
    G = rng.uniform(size=(6, K, T))
    want = np.asarray(jchc._fit_g_to_w(jnp.asarray(S), jnp.asarray(Wt), jnp.asarray(G)))
    got = tchc._fit_g_to_w(*(torch.from_numpy(x) for x in (S, Wt, G)))
    close(got, want)
    for iters in (1, 3):
        close(tchc._fit_g_to_w(*(torch.from_numpy(x) for x in (S, Wt, G)), iters=iters),
              jchc._fit_g_to_w(jnp.asarray(S), jnp.asarray(Wt), jnp.asarray(G), iters=iters))


def test_chcnmf_matches_the_oracle():
    V, _, H0, _, _ = data(11)
    S = V[:, [0, 3, 6, 12, 18]]
    G0 = np.random.default_rng(12).uniform(size=(5, K, T))
    t = tt.chcnmf(V, K, T, S_init=S, G_init=G0, H_init=H0, G_sparsity=0.05,
                  H_sparsity=0.1, maxiter=10, tolerance=1e-12, **CPU)
    Wo, Ho, Go, co = oracle.chcnmf(V, S, G0, H0, T, G_sparsity=0.05, H_sparsity=0.1,
                                   maxiter=10, tolerance=1e-12)
    for a, b in ((t.W, Wo), (t.H, Ho), (t.G, Go)):
        close(a, b)
    np.testing.assert_allclose(t.cost, co, rtol=RTOL)


def test_default_inits_run_and_are_seeded():
    V, W0, *_ = data(13)
    runs = {
        "cnmf": lambda s: tt.cnmf(V, [2, 1], T, maxiter=4, seed=s, **CPU),
        "nmf2d": lambda s: tt.nmf2d(V, K, T, P, divergence="kl", maxiter=4, seed=s, **CPU),
        "chcnmf": lambda s: tt.chcnmf(V, K, T, maxiter=4, seed=s, **CPU),
        "chcnmf_w_init": lambda s: tt.chcnmf(V, K, T, W_init=W0, maxiter=4, seed=s, **CPU),
    }
    for name, run in runs.items():
        a, b, c = run(3), run(3), run(4)
        ha, hb, hc = (np.concatenate([np_(h).ravel() for h in (r.H if isinstance(r.H, list)
                                                              else [r.H])]) for r in (a, b, c))
        assert np.array_equal(ha, hb) and not np.array_equal(ha, hc), name
        assert np.all(np.isfinite(a.cost)), name


# ---------------------------------------------------------------------------
# Goldens (tests/test_goldens.py's tolerances)
# ---------------------------------------------------------------------------

def _golden_cnmf(g, method):
    return tt.cnmf(g["V"], g["W0"].shape[1], g["W0"].shape[2], W_init=g["W0"],
                   H_init=g["H0"], maxiter=15, tolerance=1e-12, dtype=np.float64,
                   method=method, **CPU)


GOLDENS = {
    "cnmf_euclid_naive": ("cnmf_euclid", ("W",), 1e-8, lambda g: _golden_cnmf(g, "naive")),
    "cnmf_euclid_gram": ("cnmf_euclid", ("W",), 1e-8, lambda g: _golden_cnmf(g, "gram")),
    "chcnmf": ("chcnmf", ("W", "H"), 1e-8, lambda g: tt.chcnmf(
        g["V"], g["G0"].shape[1], int(g["T"]), S_init=g["S"], G_init=g["G0"],
        H_init=g["H0"], H_sparsity=float(g["H_sparsity"]), maxiter=12,
        tolerance=1e-12, dtype=np.float64, **CPU)),
    "nmf2d_kl": ("nmf2d_kl", ("W", "H"), 1e-9, lambda g: tt.nmf2d(
        g["V"], g["W0"].shape[1], g["W0"].shape[2], g["H0"].shape[2], W_init=g["W0"],
        H_init=g["H0"], divergence="kl", maxiter=15, tolerance=1e-12,
        dtype=np.float64, **CPU)),
}


@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_golden(name):
    file, fields, tol, run = GOLDENS[name]
    g = np.load(GOLD / f"{file}.npz")
    r = run(g)
    for f in fields:
        np.testing.assert_allclose(np_(getattr(r, f)), g[f], atol=tol, err_msg=f)
    np.testing.assert_allclose(r.cost, g["cost"], rtol=tol)


# ---------------------------------------------------------------------------
# Carrying factors from the JAX package; mesh; devices
# ---------------------------------------------------------------------------

def test_port_resumes_from_jax_cnmf_result():
    """A JAX cnmf run's W (m, k, T) and H, carried over by
    interop.factors_from_numpy, continue in the port as JAX continues."""
    V, W0, H0, _, _ = data(14)
    kw = dict(maxiter=6, tolerance=1e-30, divergence="kl")
    first = jt.cnmf(V, K, T, W_init=W0, H_init=H0, dtype=np.float64, **kw)
    W, H = factors_from_numpy(first, **CPU)
    assert W.shape == (M, K, T)
    t = tt.cnmf(V, K, T, W_init=W, H_init=H, **kw, **CPU)
    assert_parity(t, jt.cnmf(V, K, T, W_init=first.W, H_init=first.H,
                             dtype=np.float64, **kw))


SOLVERS = {
    "cnmf": lambda V, **kw: tt.cnmf(V, K, T, maxiter=2, **kw),
    "nmf2d": lambda V, **kw: tt.nmf2d(V, K, T, P, maxiter=2, **kw),
    "chcnmf": lambda V, **kw: tt.chcnmf(V, K, T, maxiter=2, **kw),
}


@pytest.mark.parametrize("name", sorted(SOLVERS))
def test_mesh_not_ported(name):
    """mesh= is ported (tests/test_torch_parallel_solvers.py); a mesh
    that is not a parallel.make_mesh one raises TypeError."""
    with pytest.raises(TypeError, match="make_mesh"):
        SOLVERS[name](data(15)[0], mesh=object(), **CPU)


@pytest.mark.parametrize("name", sorted(SOLVERS) + ["reconstruct"])
def test_arrays_default_to_the_card_and_raise_without_one(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        if name == "reconstruct":
            tt.reconstruct(W3, H2)
        else:
            SOLVERS[name](data(16)[0])
