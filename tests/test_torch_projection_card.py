"""The projection on the card (marked ``cuda``: skipped without a card).

``ops/projection.project_rows`` on a CUDA tensor is one launch of the
Hoyer projection kernel (``ops/kernels/hoyer.py``, a budget of N + 1
passes) and reads nothing back: held here against the plain loop on the
card (``hoyer_project_reference`` at that budget), in f64 within 1e-12
and in f32 within 1e-5 of the largest entry, with ``valid``, targets per
vector and W's columns as a strided view; and the default ``nmfsc``
projects through it, with no host read inside a projection.  Imports no
JAX (tests/test_torch_projection_kernel.py holds the plain loop against
the JAX package on the CPU).
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import nmf_toolbox_tpu_torch as tt  # noqa: E402
from nmf_toolbox_tpu_torch import core  # noqa: E402
from nmf_toolbox_tpu_torch.ops import projection as tproj  # noqa: E402
from nmf_toolbox_tpu_torch.ops.kernels import hoyer as hk  # noqa: E402

TOL = {torch.float64: 1e-12, torch.float32: 1e-5}  # of the largest entry


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("N,B,valid,per_vector", [
    (40, 7, 31, False), (2000, 50, None, False), (5000, 50, 4900, True),
    (100_000, 3, 99_000, True)])
def test_project_rows_on_card_matches_plain_loop(cuda, dtype, N, B, valid, per_vector):
    rng = np.random.default_rng(N)
    W = torch.from_numpy(rng.uniform(-0.5, 1.0, (N, B))).to(cuda, dtype)
    n = N if valid is None else valid
    k1 = (torch.from_numpy(np.array([tproj.hoyer_l1_target(n, s)
                                     for s in rng.uniform(0.3, 0.9, B)])).to(cuda, dtype)
          if per_vector else tproj.hoyer_l1_target(n, 0.6))
    reads, launches = core.host_reads, hk.hoyer_project_launches
    v, iters = tproj.project_rows(W.mT, k1, 1.0, valid)
    torch.cuda.synchronize()
    assert core.host_reads == reads and hk.hoyer_project_launches == launches + 1
    # the plain loop runs its whole budget on a card; every vector here is
    # done well within 64 passes, after which N + 1 would change nothing
    want_v, want_done, want_iters = hk.hoyer_project_reference(W.mT, k1, 1.0, 64, valid)
    assert bool(want_done.all())
    assert int((iters - want_iters).abs().max()) <= (0 if dtype == torch.float64 else 1)
    assert float((v - want_v).abs().max()) <= TOL[dtype] * float(want_v.abs().max())


@pytest.mark.cuda
def test_default_nmfsc_projects_through_the_kernel(cuda, monkeypatch):
    """Default nmfsc at a small shape, both factors sparse: the projection
    launches the kernel and no host read happens inside project_rows."""
    nmfsc_mod = importlib.import_module("nmf_toolbox_tpu_torch.models.nmfsc")
    rng = np.random.default_rng(0)
    V = rng.uniform(0.1, 1.0, (200, 300)).astype(np.float32)
    seen = []

    def counted(*args, **kw):
        reads = core.host_reads
        out = tproj.project_rows(*args, **kw)
        seen.append(core.host_reads - reads)
        return out

    monkeypatch.setattr(nmfsc_mod, "project_rows", counted)
    launches = hk.hoyer_project_launches
    res = tt.nmfsc(V, 10, W_sparsity=0.5, H_sparsity=0.6, maxiter=5, seed=1, device="cuda")
    assert res.n_iters >= 1 and np.all(np.isfinite(np.asarray(res.cost)))
    assert seen and not any(seen)
    assert hk.hoyer_project_launches - launches == len(seen)
