"""Chunked runs on the card (``run_checkpointed``): the fused KL path and
extrapolated HALS with device tensors in ``resume_state``.  Imports
nothing of JAX, so it runs on a machine with the card alone:

    python -m pytest tests/test_torch_checkpoint_card.py -m cuda --noconftest
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import nmf_toolbox_tpu_torch as tt  # noqa: E402
from nmf_toolbox_tpu_torch.utils.checkpoint import run_checkpointed  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_chunked_fused_and_hals_on_card(cuda, tmp_path):
    """On the card: a chunked fused-KL run, and its crash-resumed twin,
    are bit-identical to one call, launching each fused kernel once per
    iteration; extrapolated HALS, with device tensors in resume_state
    between chunks, is bit-identical to one call."""
    from nmf_toolbox_tpu_torch.ops.kernels import fused as fk
    rng = np.random.default_rng(16)
    V = torch.from_numpy(rng.uniform(0.1, 1, (300, 700)).astype(np.float32)).to(cuda)
    W0 = rng.uniform(size=(300, 40)).astype(np.float32)
    H0 = rng.uniform(size=(40, 700)).astype(np.float32)
    kw = dict(W_init=W0, H_init=H0, divergence="kl", method="fused", tolerance=1e-30)
    one = tt.nmf(V, 40, maxiter=12, **kw)
    before = fk.phi_dot_ht_launches, fk.wt_dot_phi_launches, fk.cost_terms_launches
    res = run_checkpointed(tt.nmf, V, 40, total_iters=12, chunk=4,
                           path=tmp_path / "f.npz", **kw)
    after = fk.phi_dot_ht_launches, fk.wt_dot_phi_launches, fk.cost_terms_launches
    assert [a - b for a, b in zip(after, before)] == [12, 12, 12]
    assert torch.equal(res.W, one.W) and torch.equal(res.H, one.H)
    assert np.array_equal(res.cost, one.cost)
    p = tmp_path / "crash.npz"
    run_checkpointed(tt.nmf, V, 40, total_iters=8, chunk=4, path=p, **kw)
    crashed = run_checkpointed(tt.nmf, V, 40, total_iters=12, chunk=4, path=p, **kw)
    assert torch.equal(crashed.W, res.W) and torch.equal(crashed.H, res.H)

    hk = dict(W_init=W0, H_init=H0, extrapolate=True, tolerance=1e-30)
    one = tt.nmf_hals(V, 40, maxiter=12, **hk)
    assert one.resume_state["Wy"].device.type == "cuda"
    res = run_checkpointed(tt.nmf_hals, V, 40, total_iters=12, chunk=5,
                           path=tmp_path / "h.npz", **hk)
    assert torch.equal(res.W, one.W) and torch.equal(res.H, one.H)
