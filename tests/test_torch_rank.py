"""Port's rank selection (nmf_toolbox_tpu_torch.rank) against the JAX
package's.

The consensus metrics and the recommendation rule get the same inputs in
both packages and must agree.  The SVD estimate draws its sketch from
another generator in each package, so it is held to the JAX package's
on an exactly low-rank V, where the spectrum does not depend on the
sketch.  The consensus sweep's default inits differ between packages,
so it is held to recovering a known rank, as tests/test_rank.py does.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import nmf_toolbox_tpu as jt  # noqa: E402
import nmf_toolbox_tpu.rank as jr  # noqa: E402
import nmf_toolbox_tpu_torch as tt  # noqa: E402
import nmf_toolbox_tpu_torch.rank as tr  # noqa: E402

CPU = {"device": "cpu"}
CURVE_ATOL = 1e-8  # f64 energy curves of an exactly low-rank V


def _blocky(k=3, m=40, n=60, noise=0.01, seed=0):
    """tests/test_rank.py's rank-k data: each column dominated by exactly
    one of k basis vectors."""
    rng = np.random.default_rng(seed)
    W = np.zeros((m, k))
    for j in range(k):
        W[j * (m // k):(j + 1) * (m // k), j] = 1.0
    H = np.zeros((k, n))
    for i in range(n):
        H[i % k, i] = 1.0 + 0.2 * rng.random()
    return W @ H + noise * rng.random((m, n))


def _random_consensus(seed):
    C = np.random.default_rng(seed).random((12, 12))
    C = (C + C.T) / 2
    np.fill_diagonal(C, 1.0)
    return C


CONSENSUS = {
    "blocks": np.kron(np.eye(3), np.ones((4, 4))),
    "random": _random_consensus(1),
    "uniform_mid": np.full((10, 10), 0.5) + 0.5 * np.eye(10),
    "identity": np.eye(10),
}


@pytest.mark.parametrize("case", sorted(CONSENSUS))
def test_consensus_metrics_match_jax(case):
    C = CONSENSUS[case]
    assert tr._consensus_metrics(C) == jr._consensus_metrics(C)


ELBOWS = {  # tests/test_rank.py's TestElbowRule, plus an unsorted sweep
    "gentle_slope": ((2, 3, 4, 5, 6, 7), [1.0] * 6, [100.0 * 0.9 ** i for i in range(6)]),
    "sharp_elbow": ((2, 3, 4, 5), [1.0] * 4, [100.0, 40.0, 39.0, 38.5]),
    "unstable_excluded": ((2, 3, 4), [1.0, 1.0, 0.7], [100.0, 30.0, 1.0]),
    "unsorted": ((5, 2, 4, 3), [0.995, 1.0, 0.97, 0.999], [10.0, 100.0, 20.0, 50.0]),
}


@pytest.mark.parametrize("case", sorted(ELBOWS))
def test_recommend_matches_jax(case):
    ranks, cophs, costs = ELBOWS[case]

    def pick(R):
        stats = [R.RankStats(rank=k, cophenetic=c, dispersion=1.0,
                             consensus=np.eye(2), mean_cost=b, best_cost=b)
                 for k, c, b in zip(ranks, cophs, costs)]
        return R._recommend(ranks, stats, 0.01, 0.2)
    assert pick(tr) == pick(jr)


def test_consensus_on_device_equals_host_count():
    """The one-hot product gives the JAX package's (S, n, n) mean of
    boolean connectivities exactly, first-maximum ties included."""
    rng = np.random.default_rng(2)
    H = rng.integers(0, 3, (5, 4, 30)).astype(np.float64)  # many ties
    labels = np.argmax(H, axis=1)
    want = (labels[:, :, None] == labels[:, None, :]).mean(axis=0)
    got = tr._consensus(torch.from_numpy(H))
    assert got.dtype == np.float64 and np.array_equal(got, want)


def _low_rank(seed=3, m=50, n=80, r=4):
    rng = np.random.default_rng(seed)
    return rng.random((m, r)) @ rng.random((r, n))


@pytest.mark.parametrize("block_size", [None, 23])
def test_estimate_rank_svd_matches_jax(block_size):
    V = _low_rank()
    kw = dict(energy=0.999, max_rank=16, dtype="float64", block_size=block_size)
    rank_t, curve_t = tt.estimate_rank_svd(V, **kw, **CPU)
    rank_j, curve_j = jt.estimate_rank_svd(V, **kw)
    assert rank_t == rank_j <= 4
    assert isinstance(curve_t, np.ndarray) and curve_t.shape == (16,)
    np.testing.assert_allclose(curve_t, curve_j, atol=CURVE_ATOL, rtol=0)


def test_estimate_rank_svd_streams_memmap_and_tensor(tmp_path):
    V = _low_rank(4, 40, 150, 5)
    np.save(tmp_path / "V.npy", V)
    Vmm = np.load(tmp_path / "V.npy", mmap_mode="r")
    rank, curve = tt.estimate_rank_svd(V, energy=0.999, max_rank=12, **CPU)
    for src in (Vmm, torch.from_numpy(V)):
        r, c = tt.estimate_rank_svd(src, energy=0.999, max_rank=12,
                                    block_size=47, **({} if torch.is_tensor(src) else CPU))
        assert r == rank <= 5
        np.testing.assert_allclose(c, curve, atol=CURVE_ATOL, rtol=0)


def test_pick_rank_recovers_true_rank():
    V = _blocky(k=3)
    sel = tt.pick_rank(V, ranks=(2, 3, 5), n_seeds=10, maxiter=150, seed=0,
                       dtype="float64", **CPU)
    assert sel.method == "consensus" and sel.recommended == 3
    by_rank = {s.rank: s for s in sel.stats}
    assert by_rank[3].cophenetic >= by_rank[5].cophenetic
    for s in sel.stats:
        assert np.isfinite(s.mean_cost) and s.best_cost <= s.mean_cost
        assert s.consensus.shape == (V.shape[1],) * 2


def test_kl_consensus_runs():
    sel = tt.consensus_stability(_blocky(k=3, seed=4), ranks=(2, 3), n_seeds=6,
                                 maxiter=100, divergence="kl", dtype="float64", **CPU)
    assert sel.recommended in (2, 3)
    assert all(np.isfinite(s.mean_cost) for s in sel.stats)


def test_pick_rank_svd_method():
    rng = np.random.default_rng(7)
    V = rng.random((40, 3)) @ rng.random((3, 50))
    kw = dict(method="svd", energy=0.999, max_rank=12, dtype="float64")
    sel = tt.pick_rank(V, **kw, **CPU)
    want = jt.pick_rank(V, **kw)
    assert sel.method == "svd" and sel.recommended == want.recommended <= 3
    assert sel.ranks == want.ranks and sel.stats == []
    np.testing.assert_allclose(sel.energy_curve, want.energy_curve, atol=CURVE_ATOL)


VALIDATION = {
    "energy": ("estimate_rank_svd", (np.ones((4, 4)),), {"energy": 1.5}, "energy"),
    "method": ("pick_rank", (np.ones((4, 4)),), {"method": "elbow"}, "unknown rank-selection"),
    "no_ranks": ("pick_rank", (np.ones((4, 4)),), {}, "candidate ranks"),
    "empty_ranks": ("consensus_stability", (np.ones((4, 4)),), {"ranks": ()}, "non-empty"),
}


@pytest.mark.parametrize("case", sorted(VALIDATION))
def test_validation_matches_jax(case):
    name, args, kw, match = VALIDATION[case]
    for pkg, extra in ((jt, {}), (tt, CPU)):
        with pytest.raises(ValueError, match=match):
            getattr(pkg, name)(*args, **kw, **extra)


def test_arrays_default_to_the_card_and_raise_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    V = _low_rank()
    for call in (lambda: tt.estimate_rank_svd(V), lambda: tt.estimate_rank_svd(V, block_size=20),
                 lambda: tt.pick_rank(V, ranks=(2,), n_seeds=2, maxiter=2)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
