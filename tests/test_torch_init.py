"""Port's NNDSVD seeding (nmf_toolbox_tpu_torch/utils/init.py) and the
``init=``/``data_dtype=`` options of its ``nmf``, against the JAX package.

Seeded sketches cannot match across packages (``torch.Generator`` vs
``jax.random``).  On an exactly rank-8 V with distinct singular values
and k = 6 the randomized SVD is exact whatever the sketch, and the sign
split is invariant to the singular vectors' signs, so 'nndsvd' and
'nndsvda' agree to 1e-12 in f64 (about 1e-15 is measured); 'nndsvdar'
fills its zeros with seeded noise and agrees on the entries that
'nndsvd' leaves positive.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import nmf_toolbox_tpu as jt  # noqa: E402
import nmf_toolbox_tpu_torch as tt  # noqa: E402
from nmf_toolbox_tpu.utils import init as ji  # noqa: E402
from nmf_toolbox_tpu_torch.core import torch_dtype  # noqa: E402
from nmf_toolbox_tpu_torch.utils import init as ti  # noqa: E402

ATOL = 1e-12   # f64 NNDSVD of an exactly low-rank V
SOLVER_RTOL = 1e-9  # f64 solver runs seeded from it
BF16_RTOL = 1e-4    # both packages accumulate the same bf16 products in
                    # f32, in different orders (about 1e-5 is measured)
CPU = {"device": "cpu"}  # the port runs arrays on the card unless told


def rank8(m=60, n=40, seed=0):
    """Nonnegative V of rank 8 with singular values far apart."""
    rng = np.random.default_rng(seed)
    U, _ = np.linalg.qr(rng.standard_normal((m, 8)))
    Q, _ = np.linalg.qr(rng.standard_normal((n, 8)))
    return np.abs(U) @ np.diag(10.0 * 0.6 ** np.arange(8)) @ np.abs(Q).T


def np_(x):
    return x.detach().cpu().numpy()


def test_cholesky_qr_matches_jax():
    A = np.random.default_rng(1).standard_normal((50, 12)) * np.arange(1, 13)
    eps = np.finfo(np.float64).eps
    want = np.asarray(ji._cholesky_qr(jnp.asarray(A), jnp.asarray(eps)))
    got = np_(ti._cholesky_qr(torch.from_numpy(A), eps))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.T @ got, np.eye(12), atol=1e-12)


@pytest.mark.parametrize("variant", ["nndsvd", "nndsvda"])
def test_nndsvd_matches_jax(variant):
    V = rank8()
    Wj, Hj = ji.nndsvd(V, 6, key=jax.random.PRNGKey(3), variant=variant)
    Wt, Ht = ti.nndsvd(torch.from_numpy(V), 6, variant=variant,
                       generator=torch.Generator().manual_seed(3))
    assert Wt.shape == (60, 6) and Ht.shape == (6, 40)
    np.testing.assert_allclose(np_(Wt), np.asarray(Wj), atol=ATOL, rtol=0)
    np.testing.assert_allclose(np_(Ht), np.asarray(Hj), atol=ATOL, rtol=0)
    if variant == "nndsvd":
        assert np.any(np_(Wt) == 0)  # the strict variant keeps hard zeros


def test_nndsvdar_matches_jax_on_positive_entries():
    V = rank8(seed=2)
    Ws, Hs = (np.asarray(x) for x in ji.nndsvd(V, 6, variant="nndsvd"))
    Wj, Hj = ji.nndsvd(V, 6, key=jax.random.PRNGKey(4), variant="nndsvdar")
    Wt, Ht = ti.nndsvd(V, 6, **CPU)  # an array, the default variant and generator
    for got, want, pos in ((Wt, Wj, Ws > 0), (Ht, Hj, Hs > 0)):
        got = np_(got)
        np.testing.assert_allclose(got[pos], np.asarray(want)[pos], atol=ATOL, rtol=0)
        fill = got[~pos]  # uniform(0, mean(V)/100)
        assert fill.size and np.all(fill > 0) and np.all(fill <= V.mean() / 100)


def test_nndsvd_errors():
    V = rank8()
    with pytest.raises(ValueError, match="k <= min"):
        ti.nndsvd(V, 41, **CPU)
    with pytest.raises(ValueError, match="variant"):
        ti.nndsvd(V, 3, variant="bogus", **CPU)


def test_seedable_and_working_eps():
    V = torch.tensor([[1.0, float("nan")], [float("nan"), 2.0]])
    assert torch.equal(ti.seedable(V), torch.tensor([[1.0, 0.0], [0.0, 2.0]]))
    f32 = float(np.finfo(np.float32).eps)
    assert ti._working_eps(torch.float64) == float(np.finfo(np.float64).eps)
    assert ti._working_eps(torch.float32) == f32
    assert ti._working_eps(torch.bfloat16) == f32  # not bf16's 7.8e-3
    assert torch_dtype("bfloat16") is torch.bfloat16
    assert torch_dtype(np.float32) is torch.float32


@pytest.mark.parametrize("solver", ["nmf", "nmf_hals"])
def test_seeded_solvers_match_jax(solver):
    V = rank8(seed=5)
    kw = dict(init="nndsvda", maxiter=10, tolerance=1e-30)
    t, j = getattr(tt, solver)(V, 6, **kw, **CPU), getattr(jt, solver)(V, 6, **kw)
    for a, b in ((t.W, j.W), (t.H, j.H)):
        np.testing.assert_allclose(np_(a), b, rtol=0,
                                   atol=SOLVER_RTOL * np.max(np.abs(b)))
    np.testing.assert_allclose(t.cost, j.cost, rtol=SOLVER_RTOL)


def test_nmf_nndsvd_preserves_product_through_renorm():
    """tests/test_nndsvd.py::test_init_nndsvd_preserves_product_through_renorm:
    nmf normalizes W's columns, so the seed's column norms must move into
    H; one update then improves on the raw seed."""
    rng = np.random.default_rng(0)
    V = (rng.gamma(2.0, 1.0, (40, 4)) @ rng.gamma(0.5, 1.0, (4, 25))).astype(np.float32)
    r = tt.nmf(V, 4, init="nndsvda", maxiter=1, tolerance=1e-30, **CPU)
    rel = np.linalg.norm(V - np_(r.W) @ np_(r.H)) / np.linalg.norm(V)
    # the wrapper's generator: CPU, seed 0
    Wn, Hn = ti.nndsvd(V, 4, variant="nndsvda", **CPU)
    rel_seed = np.linalg.norm(V - np_(Wn) @ np_(Hn)) / np.linalg.norm(V)
    assert rel < rel_seed
    np.testing.assert_allclose(np.linalg.norm(np_(r.W), axis=0), 1.0, rtol=1e-5)


def test_nmf_weighted_nndsvd_seed_with_nan():
    rng = np.random.default_rng(12)
    V = rng.uniform(0.1, 1.0, (40, 30))
    M = (rng.uniform(size=(40, 30)) < 0.7).astype(np.float64)
    r = tt.nmf(np.where(M > 0, V, np.nan), 4, weights=M, init="nndsvdar",
               maxiter=8, seed=3, **CPU)
    assert np.all(np.isfinite(r.cost))
    assert bool(torch.isfinite(r.W).all()) and bool(torch.isfinite(r.H).all())


def test_nmf_bfloat16_data_matches_jax():
    rng = np.random.default_rng(0)
    m, n, k = 60, 50, 6
    V = rng.uniform(0.1, 1, (m, n)).astype(np.float32)
    W0 = rng.uniform(size=(m, k)).astype(np.float32)
    H0 = rng.uniform(size=(k, n)).astype(np.float32)
    kw = dict(W_init=W0, H_init=H0, maxiter=20, tolerance=1e-30)
    t = tt.nmf(V, k, data_dtype="bfloat16", **kw, **CPU)
    j = jt.nmf(V, k, data_dtype="bfloat16", **kw)
    assert t.W.dtype == torch.float32  # the factors keep the compute dtype
    np.testing.assert_allclose(t.cost, j.cost, rtol=BF16_RTOL)
    for a, b in ((t.W, j.W), (t.H, j.H)):
        np.testing.assert_allclose(np_(a), b, rtol=0,
                                   atol=BF16_RTOL * np.max(np.abs(b)))
    # bf16 storage moves the trajectory away from the f32 one, slightly
    f = tt.nmf(V, k, **kw, **CPU)
    assert not np.array_equal(t.cost, f.cost)
    np.testing.assert_allclose(t.cost, f.cost, rtol=1e-2)


@pytest.mark.parametrize("cfg", [
    dict(data_dtype="bfloat16", divergence="kl"),
    dict(data_dtype="bfloat16", weights=np.ones((20, 20))),
    dict(init="nndsvd", W_init=np.ones((20, 3))),
    dict(init="nndsvd", H_init=np.ones((3, 20))),
    dict(init="nndsvdx"),
])
def test_nmf_option_guards(cfg):
    V = np.random.default_rng(9).uniform(0.1, 1, (20, 20))
    for pkg in (jt, tt):
        with pytest.raises(ValueError):
            pkg.nmf(V, 3, maxiter=2, **cfg, **(CPU if pkg is tt else {}))


def test_nmf_nndsvd_single_source_only():
    V = np.random.default_rng(10).uniform(0.1, 1, (20, 20))
    for pkg in (jt, tt):
        with pytest.raises(ValueError, match="single source"):
            pkg.nmf(V, [2, 2], init="nndsvd", maxiter=2,
                    **(CPU if pkg is tt else {}))
