"""Port's symnmf (nmf_toolbox_tpu_torch.symnmf) against the JAX package.

Same NumPy similarity and injected H_init on both sides, f64 on the CPU:
H and the cost trace agree to rtol 1e-9, n_iters and converged are
equal; the stored golden holds at tests/test_goldens.py's tolerances.
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


def blocks(rng, sizes, noise=0.05):
    """A planted block similarity (tests/test_symnmf.py's) and its labels."""
    labels = np.repeat(np.arange(len(sizes)), sizes)
    n = len(labels)
    A = ((labels[:, None] == labels[None, :]) * 0.9 + noise
         + noise * rng.uniform(size=(n, n)))
    return (A + A.T) / 2, labels


def assert_parity(t, j):
    assert torch.is_tensor(t.H) and t.H.device.type == "cpu"
    jh = np.asarray(j.H)
    np.testing.assert_allclose(t.H.numpy(), jh, rtol=RTOL, atol=RTOL * np.max(jh))
    assert t.cost.shape == np.shape(j.cost)
    np.testing.assert_allclose(t.cost, np.asarray(j.cost), rtol=RTOL, atol=0)
    assert (t.n_iters, t.converged) == (j.n_iters, j.converged)


@pytest.mark.parametrize("tolerance,maxiter", [(1e-30, 20), (1e-4, 400)])
def test_parity_with_jax(tolerance, maxiter):
    """Run out at 20 iterations, and stopped by the tolerance rule."""
    rng = np.random.default_rng(1)
    A, _ = blocks(rng, [8, 7, 5])
    H0 = rng.uniform(size=(20, 3))
    kw = dict(H_init=H0, maxiter=maxiter, tolerance=tolerance)
    j = jt.symnmf(A, 3, dtype=np.float64, **kw)
    assert_parity(tt.symnmf(A, 3, **kw, **CPU), j)
    assert j.converged == (tolerance > 1e-10)


def test_golden():
    g = np.load(GOLD / "symnmf.npz")
    r = tt.symnmf(g["A"], g["H0"].shape[1], H_init=g["H0"], maxiter=15,
                  tolerance=1e-12, dtype=np.float64, **CPU)
    np.testing.assert_allclose(r.H.numpy(), g["H"], atol=1e-9)
    np.testing.assert_allclose(r.cost, g["cost"], rtol=1e-9)


def test_clusters_planted_blocks_from_default_init():
    from itertools import permutations
    rng = np.random.default_rng(0)
    A, labels = blocks(rng, [20, 15, 25])
    r = tt.symnmf(A, 3, maxiter=300, seed=1, tolerance=1e-12, **CPU)
    pred = torch.argmax(r.H, dim=1).numpy()
    acc = max(np.mean(np.array([pm[lab] for lab in labels]) == pred)
              for pm in permutations(range(3)))
    assert acc == 1.0 and float(r.H.min()) >= 0
    assert np.all(np.diff(r.cost) <= 1e-9 * np.abs(r.cost[:-1]))


def test_port_continues_jax_result():
    """symnmf's (n, k) H from a JAX run, carried over by interop, goes on
    in the port as in JAX."""
    rng = np.random.default_rng(2)
    A, _ = blocks(rng, [6, 9])
    first = jt.symnmf(A, 2, H_init=rng.uniform(size=(15, 2)), maxiter=5,
                      tolerance=1e-30, dtype=np.float64)
    (H,) = factors_from_numpy(first, fields=("H",), **CPU)
    assert H.shape == (15, 2)
    kw = dict(maxiter=5, tolerance=1e-30)
    assert_parity(tt.symnmf(A, 2, H_init=H, **kw, **CPU),
                  jt.symnmf(A, 2, H_init=first.H, dtype=np.float64, **kw))


_R = np.random.default_rng(5)
VALIDATION = {
    "square": (_R.uniform(size=(4, 6)), {}),
    "nonnegative": (-np.eye(4), {}),
    "symmetric": (_R.uniform(size=(5, 5)), {}),
    "H_init": (np.eye(4), {"H_init": np.ones((3, 2))}),
}


@pytest.mark.parametrize("match", sorted(VALIDATION))
def test_validation_as_jax(match):
    A, cfg = VALIDATION[match]
    with pytest.raises(ValueError, match=match):
        jt.symnmf(A, 2, **cfg)
    with pytest.raises(ValueError, match=match):
        tt.symnmf(A, 2, **cfg, **CPU)


def test_mesh_not_ported():
    """mesh= is ported (tests/test_torch_parallel_solvers.py); a mesh
    that is not a parallel.make_mesh one raises TypeError."""
    with pytest.raises(TypeError, match="make_mesh"):
        tt.symnmf(np.eye(4), 2, mesh=object(), **CPU)


def test_arrays_default_to_the_card_and_raise_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tt.symnmf(np.eye(4), 2)
