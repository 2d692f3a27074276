"""mesh= for the convolutive family (cnmf, nmf2d, chcnmf) and the
projected-gradient solvers (nmfsc, cnmfsc), and the sample-axis halo
they shift with, against the JAX package on the same mesh shapes.

Four Gloo ranks on the CPU (tests/torch_mesh.py) run each case on a 1-D
mesh of 4 and a 2-D mesh of 2x2; the JAX package runs it on
``make_mesh(4)`` / ``make_mesh(shape=(2, 2))`` of the conftest's virtual
devices, and the port once more with no mesh.  Inputs are f64 from a
seeded NumPy generator with injected inits.  The narrow cases put blocks
of 3 columns under a context of T - 1 = 4, so a shift reads two
neighbours.  Tolerances are the JAX tests' (atol 1e-10 on the factors,
rtol 1e-10 on the cost; tests/test_parallel.py, test_parallel_padded.py),
and every rank's result must be bit-identical to rank 0's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import nmf_toolbox_tpu as jt  # noqa: E402
import nmf_toolbox_tpu_torch as tt  # noqa: E402
from nmf_toolbox_tpu import parallel as jpar  # noqa: E402
from nmf_toolbox_tpu_torch.ops.shift import shift_sum, stack_shifts_right  # noqa: E402

from torch_mesh import (Ranks, call_counted, halos, one_rank, same_on_ranks,  # noqa: E402
                        shift_ops)

CPU = {"device": "cpu"}
F64 = dict(dtype=np.float64, tolerance=1e-12)
KINDS = ("1d", "2d")


def jmesh(kind):
    return jpar.make_mesh(4) if kind == "1d" else jpar.make_mesh(shape=(2, 2))


@pytest.fixture(scope="module")
def ranks():
    r = Ranks(4)
    yield r
    r.close()


def arr(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def close(got, want, fields=("W", "H"), atol=1e-10, rtol=1e-10):
    for f in fields:
        np.testing.assert_allclose(got[f], arr(getattr(want, f)), atol=atol, err_msg=f)
    np.testing.assert_allclose(got["cost"], arr(want.cost), rtol=rtol)
    assert got["n_iters"] == want.n_iters


def against_both(ranks, solver, args, kw, kind, fields=("W", "H")):
    """The sharded run against the JAX package's on its mesh and the
    port's with no mesh."""
    got = ranks.solve(f"nmf_toolbox_tpu_torch.{solver}", *args, mesh=kind,
                      fields=fields + ("cost",), **kw)
    close(got, getattr(jt, solver)(*args, mesh=jmesh(kind), **kw), fields)
    close(got, getattr(tt, solver)(*args, **kw, **CPU), fields)
    return got


def problem(m, n, k, T, seed=0, P=None):
    rng = np.random.default_rng(seed)
    V = rng.uniform(0.1, 1.0, (m, n))
    H0 = rng.uniform(size=(k, n) if P is None else (k, n, P))
    return V, rng.uniform(size=(m, k, T)), H0


# ---------------------------------------------------------------------------
# The halo and the shifts it feeds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", [1, 2, 5, 11])
def test_halo_spans_neighbours(ranks, width):
    """Blocks of 3 columns: a halo of 5 spans two neighbours, one of 11
    runs past the global edge, which reads as zeros."""
    x = np.arange(2 * 12, dtype=np.float64).reshape(2, 12) + 1.0
    padded = np.pad(x, ((0, 0), (width, width)))
    for r, (left, right) in enumerate(ranks.run(halos, x, width, "1d")):
        np.testing.assert_array_equal(left, padded[:, 3 * r:3 * r + width])
        np.testing.assert_array_equal(right, padded[:, width + 3 * r + 3:
                                                    width + 3 * r + 3 + width])


@pytest.mark.parametrize("n_valid", [None, 10])
def test_sharded_shifts_are_blocks_of_the_whole(ranks, n_valid):
    """stack_shifts_right and shift_sum on a rank's block, with its halos,
    are that block of the unsharded results, the spill past n_valid
    zeroed as in the JAX package."""
    rng = np.random.default_rng(1)
    T = 5
    H, Y = rng.uniform(size=(2, 12)), rng.uniform(size=(T, 2, 12))
    whole_s = stack_shifts_right(torch.from_numpy(H), T, n_valid).numpy()
    whole_y = shift_sum(torch.from_numpy(Y)).numpy()
    for r, (s, y) in enumerate(ranks.run(shift_ops, H, Y, T, n_valid, "2d")):
        c = (r % 2) * 6  # the 2 x 2 mesh: two sample blocks of 6
        np.testing.assert_array_equal(s, whole_s[..., c:c + 6])
        np.testing.assert_allclose(y, whole_y[..., c:c + 6], rtol=1e-15)


def test_reduced_tensors_keep_their_layout():
    """A sum over one rank returns each tensor's values with its strides
    when they tile a dense block (a transpose, an unflattened frame
    stack), so the products reading it take the kernels the tensor would
    with no mesh; a strided slice comes back row-major."""
    from nmf_toolbox_tpu_torch.parallel import make_mesh
    from nmf_toolbox_tpu_torch.parallel.collectives import sum_samples
    x = torch.arange(60.0).reshape(3, 4, 5)
    cases = (x.transpose(0, 2), x.unflatten(-1, (5, 1)).transpose(-1, -2), x[:, :2])
    with one_rank():
        mesh = make_mesh(1, device_type="cpu")
        for t in cases:
            alone = sum_samples(mesh, t.clone())
            out = sum_samples(mesh, t, torch.ones(2))[0]
            for got in (alone, out):
                torch.testing.assert_close(got, t, rtol=0, atol=0)
        assert out.stride() == (10, 5, 1)  # the slice (3, 2, 5), row-major
        t = cases[0]
        assert sum_samples(mesh, t, torch.ones(2))[0].stride() == t.stride()


def test_project_rows_needs_the_axis_under_a_mesh():
    """A mesh without the vectors' axis raises: its sums would cover every
    rank while the length counted one block."""
    from nmf_toolbox_tpu_torch.ops.projection import project_rows
    from nmf_toolbox_tpu_torch.parallel import make_mesh
    with one_rank():
        mesh = make_mesh(1, device_type="cpu")
        with pytest.raises(ValueError, match="axis"):
            project_rows(torch.ones(2, 6, dtype=torch.float64), 2.0, 1.0, mesh=mesh)


# ---------------------------------------------------------------------------
# cnmf, nmf2d, chcnmf
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("div", ["euclidean", "kl", "is"])
def test_cnmf_sharded(ranks, div, kind):
    """euclidean takes the Gram step, kl and is the naive one (kl with
    its unshifted ones field)."""
    V, W0, H0 = problem(16, 64, 3, 4)
    against_both(ranks, "cnmf", (V, 3, 4),
                 dict(W_init=W0, H_init=H0, divergence=div, maxiter=10, **F64), kind)


@pytest.mark.parametrize("method", ["gram", "naive"])
def test_cnmf_context_crosses_several_blocks(ranks, method):
    """n = 10 pads to 12 on four ranks: blocks of 3 under T - 1 = 4, with
    sparsity and KL's shifted row sums past the true n."""
    V, W0, H0 = problem(12, 10, 3, 5, seed=2)
    kw = dict(W_init=W0, H_init=H0, maxiter=10, W_sparsity=0.1, H_sparsity=0.2, **F64)
    kw["divergence"] = "euclidean" if method == "gram" else "kl"
    against_both(ranks, "cnmf", (V, 3, 5), kw, "1d")


def test_cnmf_padded_2d(ranks):
    V, W0, H0 = problem(15, 61, 3, 3, seed=3)
    against_both(ranks, "cnmf", (V, 3, 3),
                 dict(W_init=W0, H_init=H0, divergence="ab", alpha=0.5, beta=0.7,
                      maxiter=8, **F64), "2d")


@pytest.mark.parametrize("shape,kind", [((16, 64), "1d"), ((16, 64), "2d"),
                                        ((12, 10), "1d")])
def test_nmf2d_sharded(ranks, shape, kind):
    V, W0, H0 = problem(*shape, 3, 4, seed=4, P=2)
    against_both(ranks, "nmf2d", (V, 3, 4, 2),
                 dict(W_init=W0, H_init=H0, divergence="kl", H_sparsity=0.1,
                      maxiter=8, **F64), kind)


@pytest.mark.parametrize("shape,kind", [((16, 64), "1d"), ((16, 64), "2d"),
                                        ((15, 61), "2d")])
def test_chcnmf_sharded(ranks, shape, kind):
    V, _, H0 = problem(*shape, 3, 3, seed=5)
    G0 = np.random.default_rng(6).uniform(size=(6, 3, 3))
    against_both(ranks, "chcnmf", (V, 3, 3),
                 dict(S_init=V[:, :6], G_init=G0, H_init=H0, H_sparsity=0.1,
                      maxiter=8, **F64), kind, fields=("W", "H", "G"))


def test_chcnmf_fits_g_to_w_on_feature_shards(ranks):
    """With W_init the inner fit of G runs on S's and W_init's rows and
    stops on the residual summed over features: the port with no mesh
    gives the same G (the JAX package draws its G start from jax.random,
    so it is held to the port only)."""
    V, W0, H0 = problem(15, 61, 3, 3, seed=7)
    kw = dict(S_init=V[:, :6], W_init=W0, H_init=H0, maxiter=6, **F64)
    got = ranks.solve("nmf_toolbox_tpu_torch.chcnmf", V, 3, 3, mesh="2d",
                      fields=("W", "H", "G", "cost"), **kw)
    close(got, tt.chcnmf(V, 3, 3, **kw, **CPU), ("W", "H", "G"))


# ---------------------------------------------------------------------------
# nmfsc, cnmfsc
# ---------------------------------------------------------------------------

SPARSE = [dict(H_sparsity=0.5), dict(W_sparsity=0.4, H_sparsity=0.5),
          dict(H_sparsity=0.5, linesearch_width=3)]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("cfg", SPARSE, ids=["H", "WH", "H_width3"])
def test_nmfsc_sharded(ranks, cfg, kind):
    rng = np.random.default_rng(8)
    V = rng.uniform(0.1, 1.0, (16, 64))
    against_both(ranks, "nmfsc", (V, 4),
                 dict(W_init=rng.uniform(size=(16, 4)), H_init=rng.uniform(size=(4, 64)),
                      maxiter=8, **cfg, **F64), kind)


def test_nmfsc_padded(ranks):
    rng = np.random.default_rng(9)
    V = rng.uniform(0.1, 1.0, (15, 61))
    against_both(ranks, "nmfsc", (V, 4),
                 dict(W_init=rng.uniform(size=(15, 4)), H_init=rng.uniform(size=(4, 61)),
                      W_sparsity=0.3, H_sparsity=0.6, maxiter=8, **F64), "2d")


def test_nmfsc_ranks_run_the_same_trials(ranks):
    """Every rank reads the same acceptance flags and projection flags,
    as many as the unsharded run: the searches' objectives and the
    projections' sums are reduced before the host reads them."""
    from nmf_toolbox_tpu_torch import core
    rng = np.random.default_rng(10)
    V = rng.uniform(0.1, 1.0, (15, 61))
    kw = dict(W_init=rng.uniform(size=(15, 4)), H_init=rng.uniform(size=(4, 61)),
              W_sparsity=0.3, H_sparsity=0.6, maxiter=10, **F64)
    res = ranks.run(call_counted, "nmf_toolbox_tpu_torch.nmfsc", V, 4, mesh="2d", **kw)
    reads = {r["host_reads"] for r in res}
    before = core.host_reads
    plain = tt.nmfsc(V, 4, **kw, **CPU)
    assert reads == {core.host_reads - before}
    close(same_on_ranks([{k: v for k, v in r.items() if k != "host_reads"} for r in res]),
          plain)


@pytest.mark.parametrize("shape,kind,cfg", [
    ((16, 64), "1d", dict(H_sparsity=0.5)),
    ((16, 64), "2d", dict(H_sparsity=0.5)),
    ((16, 64), "2d", dict()),
    ((12, 10), "1d", dict(H_sparsity=0.5, linesearch_width=2)),
    ((15, 61), "2d", dict(W_sparsity=0.4)),
], ids=["H-1d", "H-2d", "plain-2d", "H_width2-narrow", "W-padded"])
def test_cnmfsc_sharded(ranks, shape, kind, cfg):
    V, W0, H0 = problem(*shape, 3, 5 if shape[1] == 10 else 3, seed=11)
    against_both(ranks, "cnmfsc", (V, 3, W0.shape[2]),
                 dict(W_init=W0, H_init=H0, maxiter=6, **cfg, **F64), kind)
