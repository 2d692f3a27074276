"""Port's out-of-core solvers (nmf_streaming, nmf_encode_streaming) against
the JAX package.

``nmf_streaming`` draws each block's starting H itself: the test patches
``uniform_init`` in both packages' streaming modules (inside the test
only) to hand out the same NumPy arrays in call order, and passes
W_init.  Everything runs in f64 on the CPU: W, H and the cost traces
agree to rtol 1e-9, n_iters and converged are equal.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False

import jax.numpy as jnp  # noqa: E402

import nmf_toolbox_tpu as jt  # noqa: E402
import nmf_toolbox_tpu_torch as tt  # noqa: E402
from nmf_toolbox_tpu_torch.interop import factors_from_numpy  # noqa: E402

jstream = importlib.import_module("nmf_toolbox_tpu.models.streaming")
tstream = importlib.import_module("nmf_toolbox_tpu_torch.models.streaming")
RTOL = 1e-9
CPU = {"device": "cpu"}  # the port runs arrays on the card unless told
M, N, K, BLOCK = 16, 75, 3, 32  # three blocks, the last a tail of 11


def lowrank(seed, m=M, n=N):
    rng = np.random.default_rng(seed)
    return rng.gamma(2.0, 1.0, (m, K)) @ rng.gamma(0.6, 1.0, (K, n)) + 0.01


def close(a, b, name):
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=RTOL * np.max(np.abs(b)),
                               err_msg=name)


def same_block_inits(monkeypatch, seed, widths):
    """Both packages' ``uniform_init`` hand out the same arrays, in order."""
    rng = np.random.default_rng(seed)
    draws = [rng.uniform(size=(K, w)) for w in widths]
    for module, wrap in ((jstream, jnp.asarray), (tstream, torch.from_numpy)):
        it = iter(draws)
        monkeypatch.setattr(module, "uniform_init",
                            lambda *a, _it=it, _wrap=wrap, **kw: _wrap(next(_it)))


@pytest.mark.parametrize("source", ["ndarray", "memmap"])
@pytest.mark.parametrize("cfg", [
    {},
    {"forget": 0.9, "inner_iters": 2},
    {"tolerance": 5.0, "epochs": 20},  # stops early on the epoch cost
])
def test_streaming_parity_with_jax(source, cfg, monkeypatch, tmp_path):
    V = lowrank(1)
    if source == "memmap":
        np.save(tmp_path / "V.npy", V)
        V = np.load(tmp_path / "V.npy", mmap_mode="r")
    W0 = np.random.default_rng(2).uniform(size=(M, K))
    kw = {"W_init": W0, "block_size": BLOCK, "epochs": 4, "return_H": True,
          "tolerance": 1e-12, **cfg}
    widths = [BLOCK, BLOCK, N - 2 * BLOCK]
    same_block_inits(monkeypatch, 3, widths)
    j = jt.nmf_streaming(V, K, dtype=np.float64, **kw)
    t = tt.nmf_streaming(V, K, **kw, **CPU)
    assert torch.is_tensor(t.W) and isinstance(t.H, np.ndarray) and t.H.shape == (K, N)
    close(t.W, j.W, "W")
    close(t.H, j.H, "H")
    np.testing.assert_allclose(t.cost, np.asarray(j.cost), rtol=RTOL, atol=0)
    assert (t.n_iters, t.converged) == (j.n_iters, j.converged)
    if "epochs" in cfg:
        assert j.converged and j.n_iters < 20


def test_streaming_defaults_and_monotone_fit(tmp_path):
    """Seeded default inits; H is not assembled unless asked; the epoch
    cost falls; the f32 memmap run equals the ndarray run bit for bit."""
    V = lowrank(4).astype(np.float32)
    np.save(tmp_path / "V.npy", V)
    Vmm = np.load(tmp_path / "V.npy", mmap_mode="r")
    a = tt.nmf_streaming(V, K, block_size=BLOCK, epochs=6, seed=5, **CPU)
    b = tt.nmf_streaming(Vmm, K, block_size=BLOCK, epochs=6, seed=5, **CPU)
    assert a.H is None and a.W.dtype == torch.float32
    assert torch.equal(a.W, b.W) and np.array_equal(a.cost, b.cost)
    assert a.cost.dtype == np.float64 and a.cost[-1] < a.cost[0]


def test_streaming_continues_from_jax_w(monkeypatch):
    """A JAX streamed W, carried over by interop, starts the port's run."""
    V = lowrank(6)
    widths = [BLOCK, BLOCK, N - 2 * BLOCK]
    same_block_inits(monkeypatch, 7, widths)
    kw = dict(block_size=BLOCK, epochs=2, tolerance=1e-12)
    W0 = np.random.default_rng(8).uniform(size=(M, K))
    first = jt.nmf_streaming(V, K, W_init=W0, dtype=np.float64, **kw)
    (W,) = factors_from_numpy(first, fields=("W",), **CPU)
    same_block_inits(monkeypatch, 9, widths)
    t = tt.nmf_streaming(V, K, W_init=W, **kw, **CPU)
    j = jt.nmf_streaming(V, K, W_init=first.W, dtype=np.float64, **kw)
    close(t.W, j.W, "W")
    np.testing.assert_allclose(t.cost, np.asarray(j.cost), rtol=RTOL, atol=0)


def _mask(seed):
    return (np.random.default_rng(seed).uniform(size=(M, N)) < 0.8).astype(float)


ENCODE_CASES = {
    "euclidean": {},
    "kl": {"divergence": "kl"},
    "kl_weights": {"divergence": "kl", "weights": _mask(9)},
    "is_sparsity": {"divergence": "is", "H_sparsity": 0.1},
}


@pytest.mark.parametrize("case", sorted(ENCODE_CASES))
def test_encode_streaming_parity_with_jax(case, tmp_path):
    V = lowrank(10)
    rng = np.random.default_rng(11)
    W, H0 = rng.uniform(size=(M, K)), rng.uniform(size=(K, N))
    out = np.lib.format.open_memmap(tmp_path / "H.npy", mode="w+",
                                    dtype=np.float64, shape=(K, N))
    kw = {"H_init": H0, "block_size": 17, "maxiter": 8, **ENCODE_CASES[case]}
    j = jt.nmf_encode_streaming(V, W, dtype=np.float64, **kw)
    t = tt.nmf_encode_streaming(V, W, out=out, **kw, **CPU)
    assert t.H is out and torch.is_tensor(t.W)
    close(t.W, j.W, "W")
    close(np.load(tmp_path / "H.npy"), j.H, "H")
    np.testing.assert_allclose(t.cost, j.cost, rtol=RTOL, atol=0)
    assert (t.n_iters, t.converged) == (j.n_iters, j.converged)


def test_encode_streaming_equals_in_memory_encode():
    """Exact: the streamed blocks reproduce one in-memory encode."""
    V = lowrank(12)
    rng = np.random.default_rng(13)
    W, H0 = rng.uniform(size=(M, K)), rng.uniform(size=(K, N))
    s = tt.nmf_encode_streaming(V, W, H_init=H0, block_size=20, maxiter=9,
                                divergence="kl", **CPU)
    r = tt.nmf_encode(V[None], W, H_init=H0[None], maxiter=9, divergence="kl", **CPU)
    close(s.H, r.H[0], "H")
    np.testing.assert_allclose(s.cost, r.cost[0], rtol=1e-12)
    d = tt.nmf_encode_streaming(V.astype(np.float32), W, block_size=20, maxiter=4,
                                seed=3, **CPU)
    assert d.H.dtype == np.float32 and np.all(np.isfinite(d.cost))


ERRORS = {
    "out_shape": ({"out": np.zeros((K, N + 1))}, ValueError, "out must be"),
    "w_shape": ({"W": np.ones((M + 1, K))}, ValueError, r"\(m, k\)"),
    "mesh": ({"mesh": object()}, ValueError, "single-device"),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_encode_streaming_errors_as_jax(case):
    cfg, err, match = ERRORS[case]
    V = lowrank(14)
    cfg = dict(cfg)
    W = cfg.pop("W", np.ones((M, K)))
    with pytest.raises(err, match=match):
        jt.nmf_encode_streaming(V, W, maxiter=2, **cfg)
    with pytest.raises(err, match=match):
        tt.nmf_encode_streaming(V, W, maxiter=2, **cfg, **CPU)


def test_streaming_mesh_not_ported():
    """nmf_streaming's mesh= is ported (tests/test_torch_parallel_solvers.py);
    a mesh that is not a parallel.make_mesh one raises TypeError."""
    with pytest.raises(TypeError, match="make_mesh"):
        tt.nmf_streaming(lowrank(15), K, mesh=object(), **CPU)


@pytest.mark.parametrize("name", ["nmf_streaming", "nmf_encode_streaming"])
def test_arrays_default_to_the_card_and_raise_without_one(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    second = K if name == "nmf_streaming" else np.ones((M, K))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        getattr(tt, name)(lowrank(16), second, maxiter=2)
