"""Carrying factors from the JAX package into the port
(nmf_toolbox_tpu_torch.interop)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import nmf_toolbox_tpu as jt  # noqa: E402
import nmf_toolbox_tpu_torch as tt  # noqa: E402
from nmf_toolbox_tpu.utils import save_factors  # noqa: E402
from nmf_toolbox_tpu_torch.interop import factors_from_numpy, load_factors_npz  # noqa: E402

ATOL = 1e-10  # f64: the same updates in both packages, different matmul order
CPU = {"device": "cpu"}  # the port runs arrays on the card unless told


def _problem(seed=0, m=25, n=35, k=4):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.1, 1.0, (m, n)), rng.uniform(size=(m, k)),
            rng.uniform(size=(k, n)))


@pytest.mark.parametrize("div", ["euclidean", "kl"])
def test_resume_jax_checkpoint_in_port(tmp_path, div):
    """JAX runs 5 iterations and checkpoints; the port resumes for 5 more.
    A multiplicative update carries no state beyond (W, H), so that must
    match JAX running 10 at once."""
    V, W0, H0 = _problem()
    kw = dict(divergence=div, tolerance=1e-30)
    first = jt.nmf(V, 4, W_init=W0, H_init=H0, maxiter=5, **kw)
    path = tmp_path / "ckpt.npz"
    save_factors(path, first)
    ckpt = load_factors_npz(path)
    assert ckpt["n_iters"] == 5 and set(ckpt) >= {"W", "H", "cost"}
    W, H = factors_from_numpy(ckpt, **CPU)
    assert W.dtype == torch.float64 and W.device.type == "cpu"
    resumed = tt.nmf(V, 4, W_init=W, H_init=H, maxiter=5, **kw, **CPU)
    whole = jt.nmf(V, 4, W_init=W0, H_init=H0, maxiter=10, **kw)
    np.testing.assert_allclose(resumed.W.numpy(), whole.W, atol=ATOL, rtol=0)
    np.testing.assert_allclose(resumed.H.numpy(), whole.H, atol=ATOL, rtol=0)
    np.testing.assert_allclose(resumed.cost, np.asarray(whole.cost)[5:],
                               rtol=ATOL, atol=0)


def test_per_source_result_converts(tmp_path):
    V, W0, H0 = _problem(1, k=5)
    res = jt.nmf(V, [2, 3], W_init=[W0[:, :2], W0[:, 2:]],
                 H_init=[H0[:2], H0[2:]], divergence="kl", maxiter=4)
    W, H = factors_from_numpy(res, dtype=np.float32, **CPU)
    assert isinstance(W, list) and isinstance(H, list)
    assert [w.shape for w in W] == [(25, 2), (25, 3)]
    assert [h.shape for h in H] == [(2, 35), (3, 35)]
    assert all(x.dtype == torch.float32 for x in W + H)
    for a, b in zip(W + H, list(res.W) + list(res.H)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b, np.float32))
    # The same lists survive the checkpoint format, and the port takes them.
    path = tmp_path / "multi.npz"
    save_factors(path, res, extra={"note": np.arange(3)})
    ckpt = load_factors_npz(path)
    assert "extra__note" not in ckpt and "note" not in ckpt
    W2, H2 = factors_from_numpy(ckpt, **CPU)
    for a, b in zip(W2 + H2, list(res.W) + list(res.H)):
        np.testing.assert_array_equal(a.numpy(), b)
    r = tt.nmf(V, [2, 3], W_init=W2, H_init=H2, divergence="kl", maxiter=3, **CPU)
    assert isinstance(r.W, list) and len(r.W) == 2


def test_plain_dict_checkpoint_and_errors(tmp_path):
    path = tmp_path / "plain.npz"
    W, H = np.ones((3, 2)), np.full((2, 4), 2.0)
    save_factors(path, {"W": W, "H": H})
    ckpt = load_factors_npz(path)
    assert set(ckpt) == {"W", "H"}
    tW, tH = factors_from_numpy(ckpt, device="cpu", dtype=torch.float32)
    assert tW.dtype == torch.float32 and float(tH.sum()) == 16.0
    with pytest.raises(ValueError):
        factors_from_numpy({"W": W})
