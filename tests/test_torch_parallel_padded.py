"""Shape-robust sharding in the port (nmf_toolbox_tpu_torch.parallel.padding):
non-divisible shapes are zero-padded to the mesh's multiples, the
nonlinear fields of the pad region are masked from each rank's global
offsets, and the factors are sliced back.  Mirrors
tests/test_parallel_padded.py on four Gloo ranks (tests/torch_mesh.py):
each padded run on a 1-D mesh of 4 and a 2-D (2, 2) mesh matches the
JAX package on the same mesh and the port with no mesh to 1e-9, in f64,
with the same iteration count; every rank is bit-identical to rank 0.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import nmf_toolbox_tpu as jt  # noqa: E402
import nmf_toolbox_tpu_torch as tt  # noqa: E402
from nmf_toolbox_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402

from torch_mesh import Ranks, mesh_of  # noqa: E402

CPU = {"device": "cpu"}
JMESHES = {"1d": lambda: jmake_mesh(4), "2d": lambda: jmake_mesh(shape=(2, 2))}


@pytest.fixture(scope="module")
def ranks():
    r = Ranks(4)
    yield r
    r.close()


def _assert_close(got, want, fields=("W", "H"), rtol=1e-9, atol=1e-9):
    for f in fields:
        w = getattr(want, f)
        w = w.detach().cpu().numpy() if torch.is_tensor(w) else np.asarray(w)
        np.testing.assert_allclose(got[f], w, rtol=rtol, atol=atol, err_msg=f)
    np.testing.assert_allclose(got["cost"], np.asarray(want.cost), rtol=rtol,
                               err_msg="cost")
    assert got["n_iters"] == want.n_iters


def _plan(kind, m, n):
    from nmf_toolbox_tpu_torch.parallel import mesh_multiples, plan_padding
    mesh = mesh_of(kind)
    return plan_padding(None, m, n), plan_padding(mesh, m, n), mesh_multiples(mesh)


def test_plan_padding(ranks):
    from nmf_toolbox_tpu_torch.parallel import pad_amount, pad_axes
    assert pad_amount(67, 4) == 1 and pad_amount(64, 4) == 0
    x = torch.ones(2, 3, dtype=torch.float64)
    assert torch.equal(pad_axes(x, {1: 2}), torch.cat([x, torch.zeros(2, 2, dtype=x.dtype)], 1))
    assert pad_axes(x, {0: 0}) is x
    for r in ranks.run(_plan, "1d", 32, 67):
        assert r == ((0, 0, None), (0, 1, (32, 67)), (1, 4))
    for r in ranks.run(_plan, "1d", 32, 64):
        assert r[1] == (0, 0, None)
    for r in ranks.run(_plan, "2d", 33, 67):
        assert r == ((0, 0, None), (1, 1, (33, 67)), (2, 2))


@pytest.mark.parametrize("div", ["euclidean", "kl", "is", "ab"])
def test_nmf_padded(ranks, div):
    rng = np.random.default_rng(0)
    V = rng.uniform(0.1, 1.0, (33, 67))
    kw = dict(W_init=rng.uniform(size=(33, 4)), H_init=rng.uniform(size=(4, 67)),
              divergence=div, maxiter=12, tolerance=1e-12, dtype=np.float64,
              **(dict(alpha=0.7, beta=0.4) if div == "ab" else {}))
    single = tt.nmf(V, 4, **kw, **CPU)
    for kind, jmesh in JMESHES.items():
        got = ranks.solve("nmf_toolbox_tpu_torch.nmf", V, 4, mesh=kind, **kw)
        _assert_close(got, single)
        _assert_close(got, jt.nmf(V, 4, mesh=jmesh(), **kw))


def test_nmf_padded_weighted(ranks):
    """weights= pads with zeros like V and takes V's placement."""
    rng = np.random.default_rng(1)
    V = rng.uniform(0.1, 1.0, (33, 67))
    kw = dict(W_init=rng.uniform(size=(33, 4)), H_init=rng.uniform(size=(4, 67)),
              weights=(rng.uniform(size=(33, 67)) < 0.8).astype(np.float64),
              divergence="kl", maxiter=8, tolerance=1e-12, dtype=np.float64)
    got = ranks.solve("nmf_toolbox_tpu_torch.nmf", V, 4, mesh="2d", **kw)
    _assert_close(got, tt.nmf(V, 4, **kw, **CPU))
    _assert_close(got, jt.nmf(V, 4, mesh=JMESHES["2d"](), **kw))
    bad = dict(kw, weights=-kw["weights"])
    from torch_mesh import RankError
    with pytest.raises(RankError, match="nonnegative and NaN-free"):
        ranks.solve("nmf_toolbox_tpu_torch.nmf", V, 4, mesh="2d", **bad)
