"""Carrying factors from the JAX package into the port
(nmf_toolbox_tpu_torch.interop)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import nmf_toolbox_tpu as jt  # noqa: E402
import nmf_toolbox_tpu_torch as tt  # noqa: E402
from nmf_toolbox_tpu.utils import save_factors  # noqa: E402
from nmf_toolbox_tpu_torch.interop import (factors_from_numpy, load_factors_npz,  # noqa: E402
                                           resume_state_from_numpy)

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


# ---------------------------------------------------------------------------
# The projected-gradient and complex solvers' state
# ---------------------------------------------------------------------------

def _sparse_problem(seed=0, m=24, n=36, k=4, T=None):
    rng = np.random.default_rng(seed)
    V = rng.uniform(0.05, 1.0, (m, n))
    W0 = rng.uniform(size=(m, k) if T is None else (m, k, T))
    H0 = rng.uniform(size=(k, n))
    return V, W0, H0 / np.sqrt((H0 ** 2).sum(1, keepdims=True))


@pytest.mark.parametrize("solver", ["nmfsc", "cnmfsc"])
def test_resume_jax_line_search_state_in_port(solver):
    """JAX runs 12 iterations; the port takes its W, H and stepsizes
    (nmfsc's floats, cnmfsc's (T,) step_w) and runs 12 more, which must
    match JAX running 24 at once."""
    kw = dict(H_sparsity=0.6, tolerance=1e-30, dtype=np.float64)
    if solver == "nmfsc":
        V, W0, H0 = _sparse_problem()
        kw["W_sparsity"] = 0.5
        jrun = lambda **c: jt.nmfsc(V, 4, **c, **kw)  # noqa: E731
        trun = lambda **c: tt.nmfsc(V, 4, **c, **kw, **CPU)  # noqa: E731
    else:
        V, W0, H0 = _sparse_problem(k=3, T=3)
        jrun = lambda **c: jt.cnmfsc(V, 3, 3, **c, **kw)  # noqa: E731
        trun = lambda **c: tt.cnmfsc(V, 3, 3, **c, **kw, **CPU)  # noqa: E731
    first = jrun(W_init=W0, H_init=H0, maxiter=12)
    whole = jrun(W_init=W0, H_init=H0, maxiter=24)
    rs = resume_state_from_numpy(first.resume_state, **CPU)
    if solver == "cnmfsc":
        assert isinstance(rs["step_w"], np.ndarray) and rs["step_w"].shape == (3,)
    else:
        assert type(rs["step_w"]) is float
    W, H = factors_from_numpy(first, **CPU)
    rest = trun(W_init=W, H_init=H, maxiter=12, resume_state=rs)
    assert rest.n_iters == 12
    np.testing.assert_allclose(rest.W.numpy(), whole.W, atol=ATOL, rtol=0)
    np.testing.assert_allclose(rest.H.numpy(), whole.H, atol=ATOL, rtol=0)
    np.testing.assert_allclose(rest.cost, np.asarray(whole.cost)[12:], rtol=ATOL, atol=0)
    np.testing.assert_allclose(rest.resume_state["step_h"], whole.resume_state["step_h"],
                               rtol=1e-12)


def test_resume_state_from_numpy_line_search_kinds():
    out = resume_state_from_numpy({"step_w": np.float32(0.5), "step_h": 1.2})
    assert out == {"step_w": 0.5, "step_h": 1.2} and type(out["step_w"]) is float
    sw = np.array([1.0, 0.6, 0.3])
    out = resume_state_from_numpy({"step_w": sw, "step_h": np.float64(2.0)})
    assert type(out["step_h"]) is float and np.array_equal(out["step_w"], sw)
    sw[0] = 9.0  # a copy, not a view
    assert out["step_w"][0] == 1.0
    with pytest.raises(ValueError, match="step_w"):
        resume_state_from_numpy({"step_h": 1.0}, **CPU)


def test_cmfwisa_phase_continues_in_port(tmp_path):
    """cmfwisa's complex P crosses with W and H (also through the
    checkpoint format): JAX 5 iterations, then the port 5 more with
    P_init, match JAX running 10."""
    rng = np.random.default_rng(3)
    V = rng.normal(size=(16, 22)) + 1j * rng.normal(size=(16, 22))
    W0, H0 = rng.uniform(size=(16, 3)), rng.uniform(size=(3, 22))
    kw = dict(tolerance=1e-30, dtype=np.complex128, H_sparsity=0.1)
    first = jt.cmfwisa(V, 3, W_init=W0, H_init=H0, maxiter=5, **kw)
    whole = jt.cmfwisa(V, 3, W_init=W0, H_init=H0, maxiter=10, **kw)
    path = tmp_path / "cmf.npz"
    save_factors(path, first)
    for src in (first, load_factors_npz(path)):
        W, H, P = factors_from_numpy(src, fields=("W", "H", "P"), dtype=np.float64, **CPU)
        assert P.dtype == torch.complex128 and W.dtype == torch.float64
        np.testing.assert_array_equal(P.numpy(), first.P)
        rest = tt.cmfwisa(V, 3, W_init=W, H_init=H, P_init=P, maxiter=5, **kw, **CPU)
        np.testing.assert_allclose(rest.W.numpy(), whole.W, atol=ATOL, rtol=0)
        np.testing.assert_allclose(rest.H.numpy(), whole.H, atol=ATOL, rtol=0)
        np.testing.assert_allclose(rest.P.numpy(), whole.P, atol=ATOL, rtol=0)
        np.testing.assert_allclose(rest.cost, np.asarray(whole.cost)[5:], rtol=ATOL, atol=0)
    _, _, P32 = factors_from_numpy(first, fields=("W", "H", "P"), dtype=np.float32, **CPU)
    assert P32.dtype == torch.complex64


NEW_ENTRY_POINTS = {
    "nmfsc": lambda V: tt.nmfsc(V, 2, maxiter=2),
    "cnmfsc": lambda V: tt.cnmfsc(V, 2, 2, maxiter=2),
    "cmfwisa": lambda V: tt.cmfwisa(V, 2, maxiter=2),
    "cmfwisa_encode": lambda V: tt.cmfwisa_encode(V[None], V[:, :2], maxiter=2),
    "projfunc": lambda V: tt.projfunc(V[0], 1.5, 1.0),
    "stft": lambda V: tt.stft(V[0], n_fft=4, hop_length=2),
    "istft": lambda V: tt.istft(V + 0j, hop_length=2),
    "magnitude": lambda V: tt.magnitude(V),
    "griffinlim": lambda V: tt.griffinlim(V, n_iter=1, hop_length=2),
    "wiener_masks": lambda V: tt.wiener_masks([V[:, :2]], [V[:2]]),
    "separate": lambda V: tt.separate(V, [V[:, :2]], [V[:2]]),
    "separate_waveforms": lambda V: tt.separate_waveforms(V + 0j, [V[:, :2]], [V[:2]],
                                                          hop_length=2),
}


@pytest.mark.parametrize("name", sorted(NEW_ENTRY_POINTS))
def test_new_entry_points_need_a_device(name, monkeypatch):
    """An array with no device= goes to the card, so with no card every
    entry point of this slice raises and names device="cpu"."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    V = np.random.default_rng(0).uniform(0.1, 1.0, (5, 12))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        NEW_ENTRY_POINTS[name](V)
