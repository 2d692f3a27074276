"""The port's mesh= (nmf_toolbox_tpu_torch.parallel) against the JAX
package's on the same mesh shapes.

Four Gloo ranks on the CPU (tests/torch_mesh.py) run each case; the JAX
package runs it on ``make_mesh(4)`` / ``make_mesh(shape=(2, 2))`` of the
conftest's virtual devices, and the port once more with no mesh.  Inputs
come from a seeded NumPy generator, in f64 unless a case needs f32.
Tolerances are those of the JAX tests the cases mirror: atol 1e-10 on
the factors and rtol 1e-10 on the cost (tests/test_parallel.py), 1e-9
for the batched and HALS cases (tests/test_batched.py, test_hals.py),
rtol 2e-4 for the f32 weighted and accelerated runs (test_weighted.py,
test_accel.py).  The fused path is f32 only; on the CPU its kernels'
plain versions run on each rank's block, held at 1e-4 against the port
with no mesh and the JAX package on the mesh (the f32 summation orders
differ), and at tests/test_pallas.py's thresholds against naive.  Every
rank's result must be bit-identical to rank 0's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import nmf_toolbox_tpu as jt  # noqa: E402
import nmf_toolbox_tpu_torch as tt  # noqa: E402
from nmf_toolbox_tpu import parallel as jpar  # noqa: E402
from nmf_toolbox_tpu_torch import parallel as tpar  # noqa: E402

from torch_mesh import (Ranks, RankError, assert_ranks_identical, consensus,  # noqa: E402
                        estimator, one_rank, run_cli)

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


def close(got, want, atol=1e-10, rtol=1e-10, fields=("W", "H")):
    for f in fields:
        np.testing.assert_allclose(arr(got[f]), arr(getattr(want, f)), atol=atol,
                                   err_msg=f)
    np.testing.assert_allclose(got["cost"], arr(want.cost), rtol=rtol)


def make_problem(m=32, n=64, k=4, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.1, 1.0, (m, n)), rng.uniform(size=(m, k)),
            rng.uniform(size=(k, n)))


# ---------------------------------------------------------------------------
# The layer itself
# ---------------------------------------------------------------------------

def test_parallel_all_equals_jax():
    assert tpar.__all__ == jpar.__all__
    for name in tpar.__all__:
        assert getattr(tpar, name).__module__.startswith("nmf_toolbox_tpu_torch.")


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="init_distributed"):
        tpar.make_mesh(1)


def test_make_mesh_without_a_card_raises(monkeypatch):
    """With no device_type the mesh is one of CUDA cards: with no card it
    raises (never a silent CPU mesh), and device_type="cpu" still builds
    the CPU mesh."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with one_rank():
        with pytest.raises(RuntimeError, match='device_type="cpu"'):
            tpar.make_mesh(1)
        with pytest.raises(RuntimeError, match="finds none"):
            tpar.make_mesh(shape=(1, 1), device_type="cuda")
        assert tpar.make_mesh(1, device_type="cpu").device == torch.device("cpu")


def test_placement_tables_complete():
    """Every solver's placements, on a 1-D and a 2-D mesh, are the JAX
    package's PartitionSpecs entry for entry."""
    solvers = ["nmf", "lnmf", "nmfsc", "seminmf", "constrainednmf", "cnmf",
               "cnmfsc", "cmfwisa", "symnmf", "nmf2d", "convexnmf", "chnmf",
               "chcnmf", "nmf_batched", "nmf_encode", "cnmf_encode",
               "cmfwisa_encode", "nmf2d_encode", "nmf_multiseed"]
    with one_rank():
        for tmesh, jm in ((tpar.make_mesh(1, device_type="cpu"), jpar.make_mesh(4)),
                          (tpar.make_mesh(shape=(1, 1), device_type="cpu"),
                           jpar.make_mesh(shape=(2, 2)))):
            for solver in solvers:
                specs = tpar.placements_for(solver, tmesh)
                assert "V" in specs or "A" in specs
                want = {k: tuple(v) + (None,) * (len(specs[k]) - len(v))
                        for k, v in jpar.placements_for(solver, jm).items()}
                assert specs == want, solver


def test_foreign_mesh_raises_typeerror():
    V = np.random.default_rng(0).uniform(0.1, 1, (8, 8))
    for call in (lambda **kw: tt.nmf(V, 2, maxiter=1, **kw),
                 lambda **kw: tt.nmf_hals(V, 2, maxiter=1, **kw),
                 lambda **kw: tt.nmf_multiseed(V, 2, 2, maxiter=1, **kw)):
        with pytest.raises(TypeError, match="make_mesh"):
            call(mesh=jmesh("1d"), **CPU)


# ---------------------------------------------------------------------------
# nmf
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("div", ["euclidean", "kl"])
def test_nmf_sharded_matches_single(ranks, div, kind):
    V, W0, H0 = make_problem()
    kw = dict(W_init=W0, H_init=H0, divergence=div, maxiter=20, **F64)
    got = ranks.solve("nmf_toolbox_tpu_torch.nmf", V, 4, mesh=kind, **kw)
    close(got, jt.nmf(V, 4, mesh=jmesh(kind), **kw))
    close(got, tt.nmf(V, 4, **kw, **CPU))


def test_nmf_sharded_2d_mesh(ranks):
    V, W0, H0 = make_problem()
    kw = dict(W_init=W0, H_init=H0, maxiter=15, method="gram", **F64)
    got = ranks.solve("nmf_toolbox_tpu_torch.nmf", V, 4, mesh="2d", **kw)
    close(got, jt.nmf(V, 4, mesh=jmesh("2d"), **kw))


@pytest.mark.parametrize("kind", KINDS)
def test_nmf_sources_sparsity_fixed_on_mesh(ranks, kind):
    """Two sources with per-source sparsity, one basis frozen: the
    penalties' sums and the fixed-column masks on local blocks."""
    V, W0, H0 = make_problem(k=5, seed=3)
    kw = dict(W_init=[W0[:, :3], W0[:, 3:]], H_init=[H0[:3], H0[3:]],
              W_sparsity=[0.1, 0.0], H_sparsity=[0.0, 0.2],
              W_fixed=[False, True], divergence="kl", maxiter=10, **F64)
    got = ranks.solve("nmf_toolbox_tpu_torch.nmf", V, [3, 2], mesh=kind, **kw)
    want = jt.nmf(V, [3, 2], mesh=jmesh(kind), **kw)
    for s in range(2):
        np.testing.assert_allclose(got["W"][s], want.W[s], atol=1e-10)
        np.testing.assert_allclose(got["H"][s], want.H[s], atol=1e-10)
    np.testing.assert_allclose(got["cost"], want.cost, rtol=1e-10)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("div", ["kl", "is"])
def test_nmf_fused_on_local_blocks(ranks, div, kind):
    V, W0, H0 = (x.astype(np.float32) for x in make_problem(m=32, n=48, seed=4))
    kw = dict(W_init=W0, H_init=H0, divergence=div, maxiter=8,
              tolerance=1e-30, dtype=np.float32)
    got = ranks.solve("nmf_toolbox_tpu_torch.nmf", V, 4, mesh=kind,
                      method="fused", **kw)
    close(got, tt.nmf(V, 4, method="fused", **kw, **CPU), atol=1e-5, rtol=1e-4)
    close(got, jt.nmf(V, 4, method="fused", mesh=jmesh(kind), **kw),
          atol=1e-5, rtol=1e-4)
    naive = ranks.solve("nmf_toolbox_tpu_torch.nmf", V, 4, mesh=kind,
                        method="naive", **kw)
    np.testing.assert_allclose(got["cost"], naive["cost"], rtol=2e-3)
    np.testing.assert_allclose(got["W"], naive["W"], atol=2e-3)
    np.testing.assert_allclose(got["H"], naive["H"], atol=2e-2)


def test_nmf_fused_refuses_padding(ranks):
    V, W0, H0 = (x.astype(np.float32) for x in make_problem(m=33, n=48))
    with pytest.raises(RankError, match="method='fused' does not support mesh"):
        ranks.solve("nmf_toolbox_tpu_torch.nmf", V, 4, mesh="2d", method="fused",
                    divergence="kl", maxiter=2)
    with pytest.raises(ValueError, match="method='fused' does not support mesh"):
        jt.nmf(V, 4, method="fused", divergence="kl", maxiter=2, mesh=jmesh("2d"))


def test_weighted_composes_with_mesh(ranks):
    rng = np.random.default_rng(11)
    m, n = 64, 67  # non-divisible n
    V = (rng.gamma(2.0, 1.0, (m, 5)) @ rng.gamma(0.5, 1.0, (5, n)) + 0.01)
    W0, H0 = rng.uniform(0.1, 1.0, (m, 6)), rng.uniform(0.1, 1.0, (6, n))
    M = (rng.uniform(size=(m, n)) < 0.8).astype(np.float64)
    V, W0, H0, M = (x.astype(np.float32) for x in (V, W0, H0, M))
    kw = dict(W_init=W0, H_init=H0, weights=M, maxiter=6, tolerance=1e-30)
    single = tt.nmf(V, 6, **kw, **CPU)
    for kind in KINDS:
        got = ranks.solve("nmf_toolbox_tpu_torch.nmf", V, 6, mesh=kind, **kw)
        np.testing.assert_allclose(got["W"], arr(single.W), rtol=2e-4, atol=1e-6)
        np.testing.assert_allclose(got["cost"], single.cost, rtol=2e-4)
        want = jt.nmf(V, 6, mesh=jmesh(kind), **kw)
        np.testing.assert_allclose(got["W"], want.W, rtol=2e-4, atol=1e-6)
        np.testing.assert_allclose(got["cost"], want.cost, rtol=2e-4)


def test_inner_composes_with_mesh(ranks):
    rng = np.random.default_rng(2)
    m, n = 64, 67  # non-divisible n
    V = (rng.gamma(2.0, 1.0, (m, 8)) @ rng.gamma(0.5, 1.0, (8, n)) + 0.01)
    V, W0, H0 = (x.astype(np.float32) for x in
                 (V, rng.uniform(size=(m, 10)), rng.uniform(size=(10, n))))
    kw = dict(W_init=W0, H_init=H0, maxiter=6, tolerance=1e-30, inner_iters=2)
    single = tt.nmf(V, 10, **kw, **CPU)
    got = ranks.solve("nmf_toolbox_tpu_torch.nmf", V, 10, mesh="1d", **kw)
    np.testing.assert_allclose(got["W"], arr(single.W), rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(got["cost"], single.cost, rtol=2e-4)
    want = jt.nmf(V, 10, mesh=jmesh("1d"), **kw)
    np.testing.assert_allclose(got["cost"], want.cost, rtol=2e-4)


def test_nmf_stop_rule_on_mesh(ranks):
    """The stop rule reads the all-reduced cost: every rank stops at the
    same iteration, the unmeshed run's."""
    V, W0, H0 = make_problem(seed=5)
    kw = dict(W_init=W0, H_init=H0, divergence="kl", maxiter=500,
              tolerance=3e-2, dtype=np.float64)
    got = ranks.solve("nmf_toolbox_tpu_torch.nmf", V, 4, mesh="2d", **kw)
    single = tt.nmf(V, 4, **kw, **CPU)
    assert single.converged and got["n_iters"] == single.n_iters < 500
    close(got, single)


@pytest.mark.parametrize("solver", ["nmf", "nmf_hals"])
def test_nndsvd_init_on_mesh(ranks, solver):
    """init='nndsvd*' under a mesh seeds from the whole V on the mesh's
    device, as the call with no mesh seeds on its own: the same factors."""
    V = make_problem(m=32, n=64)[0]
    kw = dict(init="nndsvda", maxiter=10, **F64)
    got = ranks.solve(f"nmf_toolbox_tpu_torch.{solver}", V, 4, mesh="1d", **kw)
    close(got, getattr(tt, solver)(V, 4, **kw, **CPU))


# ---------------------------------------------------------------------------
# nmf_hals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_hals_early_stop_and_mesh(ranks, kind):
    rng = np.random.default_rng(1)
    V = rng.uniform(0.1, 1, (24, 64))
    W0, H0 = rng.uniform(size=(24, 3)), rng.uniform(size=(3, 64))
    kw = dict(W_init=W0, H_init=H0, maxiter=10, tolerance=1e-30, dtype=np.float64)
    got = ranks.solve("nmf_toolbox_tpu_torch.nmf_hals", V, 3, mesh=kind, **kw)
    close(got, jt.nmf_hals(V, 3, mesh=jmesh(kind), **kw), atol=1e-9, rtol=1e-9)
    close(got, tt.nmf_hals(V, 3, **kw, **CPU), atol=1e-9, rtol=1e-9)


def _hals_gap_problem(m=2000, n=1000, rank=20, seed=0):
    """V of the HALS mesh-gap question: a rank-20 gamma product plus U(0, 0.1)."""
    rng = np.random.default_rng(seed)
    return (rng.gamma(2.0, 1.0, (m, rank)) @ rng.gamma(1.0, 1.0, (rank, n))
            + rng.uniform(0, 0.1, (m, n)))


@pytest.mark.parametrize("kind", KINDS)
def test_hals_nndsvda_mesh_gap_follows_the_reference(ranks, kind):
    """HALS from NNDSVDA seeds, f64, 2000x1000 r50: the gap between four
    ranks and no mesh (max |dW| / max |W|) grows with the sweeps as the
    JAX package's own gap between its 4-device mesh and no mesh grows,
    from sums in another order; the port's stays within 100x of it
    (floored at 1e-15), and after one sweep both stay below 1e-12."""
    V = _hals_gap_problem()
    for sweeps in (1, 5, 10):
        kw = dict(init="nndsvda", maxiter=sweeps, tolerance=1e-30, dtype=np.float64)
        got = ranks.solve("nmf_toolbox_tpu_torch.nmf_hals", V, 50, mesh=kind, **kw)
        # One thread, as each rank runs: two threads split the BLAS sums
        # otherwise and move W by 2e-10 after one sweep with no mesh at all.
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            one = arr(tt.nmf_hals(V, 50, **kw, **CPU).W)
        finally:
            torch.set_num_threads(threads)
        port_gap = np.max(np.abs(got["W"] - one)) / np.max(np.abs(one))
        jone = np.asarray(jt.nmf_hals(V, 50, **kw).W)
        jax_gap = (np.max(np.abs(np.asarray(jt.nmf_hals(V, 50, mesh=jmesh(kind), **kw).W)
                                 - jone)) / np.max(np.abs(jone)))
        print(f"{kind} {sweeps} sweeps: port {port_gap:.3g}, JAX {jax_gap:.3g}")
        assert port_gap <= 100 * max(jax_gap, 1e-15), (sweeps, port_gap, jax_gap)
        if sweeps == 1:
            assert port_gap < 1e-12 and jax_gap < 1e-12


@pytest.mark.parametrize("opt", [dict(extrapolate=True), dict(inner_iters=2),
                                 dict(weights=True)])
def test_hals_options_on_mesh(ranks, opt):
    rng = np.random.default_rng(2)
    V = rng.uniform(0.1, 1, (24, 64))
    W0, H0 = rng.uniform(size=(24, 3)), rng.uniform(size=(3, 64))
    if "weights" in opt:
        opt = dict(weights=(rng.uniform(size=V.shape) < 0.8).astype(np.float64))
    kw = dict(W_init=W0, H_init=H0, maxiter=8, tolerance=1e-30,
              dtype=np.float64, **opt)
    got = ranks.solve("nmf_toolbox_tpu_torch.nmf_hals", V, 3, mesh="2d", **kw)
    close(got, jt.nmf_hals(V, 3, mesh=jmesh("2d"), **kw), atol=1e-9, rtol=1e-9)


def test_hals_refuses_nondivisible_shape(ranks):
    V = np.random.default_rng(3).uniform(0.1, 1, (24, 66))
    with pytest.raises(RankError, match="not divide") as e:
        ranks.solve("nmf_toolbox_tpu_torch.nmf_hals", V, 3, mesh="1d", maxiter=2,
                    dtype=np.float64)
    assert e.value.kind == "ValueError"
    with pytest.raises(ValueError, match="divisible"):
        jt.nmf_hals(V, 3, maxiter=2, dtype=np.float64, mesh=jmesh("1d"))


# ---------------------------------------------------------------------------
# The batched engines (tests/test_batched.py's seven mesh tests)
# ---------------------------------------------------------------------------

def test_batched_sharded_matches_single_device(ranks):
    rng = np.random.default_rng(2)
    B, m, n, k = 16, 12, 18, 2
    Vs = rng.uniform(0.1, 1, (B, m, n))
    kw = dict(W_init=rng.uniform(size=(B, m, k)), H_init=rng.uniform(size=(B, k, n)),
              maxiter=10, dtype=np.float64)
    for div in ("euclidean", "kl"):
        got = ranks.solve("nmf_toolbox_tpu_torch.nmf_batched", Vs, k, mesh="2d",
                          divergence=div, **kw)
        want = jt.nmf_batched(Vs, k, divergence=div, mesh=jmesh("1d"), **kw)
        close(got, want)
        close(got, tt.nmf_batched(Vs, k, divergence=div, **kw, **CPU))


def test_encode_sharded_matches_single_device(ranks):
    rng = np.random.default_rng(10)
    B, m, n, k = 16, 12, 18, 2
    Vs = rng.uniform(0.1, 1, (B, m, n))
    W, H0 = rng.uniform(size=(m, k)), rng.uniform(size=(B, k, n))
    kw = dict(H_init=H0, maxiter=10, dtype=np.float64)
    got = ranks.solve("nmf_toolbox_tpu_torch.nmf_encode", Vs, W, mesh="1d", **kw)
    close(got, jt.nmf_encode(Vs, W, mesh=jmesh("1d"), **kw), fields=("H",))
    close(got, tt.nmf_encode(Vs, W, **kw, **CPU), fields=("W", "H"))


def test_conv_encode_sharded_and_validation(ranks):
    rng = np.random.default_rng(16)
    B, m, n, k, T = 8, 10, 14, 2, 2
    Vs = rng.uniform(0.1, 1, (B, m, n))
    W = rng.uniform(0.1, 1, (m, k, T))
    H0 = rng.uniform(size=(B, k, n))
    kw = dict(H_init=H0, maxiter=8, dtype=np.float64)
    got = ranks.solve("nmf_toolbox_tpu_torch.cnmf_encode", Vs, W, mesh="1d", **kw)
    close(got, jt.cnmf_encode(Vs, W, mesh=jmesh("1d"), **kw), fields=("H",))
    close(got, tt.cnmf_encode(Vs, W, **kw, **CPU), fields=("W", "H"))


def test_encode_mesh_divisibility_error(ranks):
    rng = np.random.default_rng(24)
    Vs = rng.uniform(0.1, 1, (3, 8, 10)).astype(np.float32)
    W = rng.uniform(size=(8, 2)).astype(np.float32)
    W3 = rng.uniform(size=(8, 2, 2)).astype(np.float32)
    for fn, args in (("nmf_encode", (Vs, W)), ("cnmf_encode", (Vs, W3)),
                     ("nmf_batched", (Vs, 2)), ("nmf2d_encode", (Vs, W3, 2)),
                     ("cmfwisa_encode", (Vs.astype(np.complex64), W))):
        with pytest.raises(RankError, match="multiple of the mesh") as e:
            ranks.solve(f"nmf_toolbox_tpu_torch.{fn}", *args, maxiter=2, mesh="1d")
        assert e.value.kind == "ValueError"
        with pytest.raises(ValueError, match="multiple of the mesh"):
            getattr(jt, fn)(*args, maxiter=2, mesh=jmesh("1d"))


def test_encode_weighted_sharded_matches_single_device(ranks):
    rng = np.random.default_rng(25)
    B, m, n, k = 8, 10, 14, 2
    Vs = rng.uniform(0.1, 1, (B, m, n))
    W, H0 = rng.uniform(size=(m, k)), rng.uniform(size=(B, k, n))
    for Mw in ((rng.uniform(size=(m, n)) < 0.8).astype(float),
               (rng.uniform(size=(B, m, n)) < 0.8).astype(float)):
        kw = dict(H_init=H0, weights=Mw, divergence="kl", maxiter=8, dtype=np.float64)
        got = ranks.solve("nmf_toolbox_tpu_torch.nmf_encode", Vs, W, mesh="2d", **kw)
        close(got, jt.nmf_encode(Vs, W, mesh=jmesh("2d"), **kw), fields=("H",))


def test_cmfwisa_encode_sharded_and_validation(ranks):
    rng = np.random.default_rng(32)
    B, m, n, k = 8, 8, 10, 2
    Vs = (rng.uniform(0.1, 1, (B, m, n))
          * np.exp(1j * rng.uniform(-np.pi, np.pi, (B, m, n))))
    W, H0 = rng.uniform(size=(m, k)), rng.uniform(size=(B, k, n))
    kw = dict(H_init=H0, maxiter=8, dtype=np.complex128)
    got = ranks.solve("nmf_toolbox_tpu_torch.cmfwisa_encode", Vs, W, mesh="1d",
                      fields=("H", "P", "cost"), **kw)
    close(got, jt.cmfwisa_encode(Vs, W, mesh=jmesh("1d"), **kw), fields=("H", "P"))
    close(got, tt.cmfwisa_encode(Vs, W, **kw, **CPU), fields=("H", "P"))


def test_nmf2d_encode_sparsity_sharded_validation(ranks):
    rng = np.random.default_rng(61)
    B, m, n, k, T, P = 8, 10, 14, 2, 2, 2
    Vs = rng.uniform(0.1, 1, (B, m, n))
    W = rng.uniform(0.1, 1, (m, k, T))
    kw = dict(H_init=rng.uniform(0.1, 1, (B, k, n, P)), H_sparsity=0.3, maxiter=8,
              dtype=np.float64)
    got = ranks.solve("nmf_toolbox_tpu_torch.nmf2d_encode", Vs, W, P, mesh="1d", **kw)
    close(got, jt.nmf2d_encode(Vs, W, P, mesh=jmesh("1d"), **kw), fields=("H",))


# ---------------------------------------------------------------------------
# Restarts and rank selection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_multiseed_sharded(ranks, kind):
    """Restarts shard over the sample axis; V over features on the 2-D
    mesh, where 17 rows need the zero pad."""
    rng = np.random.default_rng(9)
    V = rng.uniform(0.05, 1, (17, 40))
    S, k = 8, 3
    kw = dict(W_init=rng.uniform(size=(S, 17, k)), H_init=rng.uniform(size=(S, k, 40)),
              maxiter=10, dtype=np.float64)
    got = ranks.solve("nmf_toolbox_tpu_torch.nmf_multiseed", V, k, S, mesh=kind, **kw)
    want = jt.nmf_multiseed(V, k, S, mesh=jmesh(kind), **kw)
    close(got, want, atol=1e-9, rtol=1e-9)
    close(got, tt.nmf_multiseed(V, k, S, **kw, **CPU), atol=1e-9, rtol=1e-9)


def test_multiseed_kl_sharded_padded(ranks):
    rng = np.random.default_rng(11)
    V = rng.uniform(0.05, 1, (17, 40))
    S, k = 8, 3
    kw = dict(divergence="kl", W_init=rng.uniform(size=(S, 17, k)),
              H_init=rng.uniform(size=(S, k, 40)), maxiter=8, dtype=np.float64)
    got = ranks.solve("nmf_toolbox_tpu_torch.nmf_multiseed", V, k, S, mesh="2d", **kw)
    close(got, jt.nmf_multiseed(V, k, S, mesh=jmesh("2d"), **kw), atol=1e-9, rtol=1e-9)
    with pytest.raises(RankError, match="n_seeds=6 must be a multiple"):
        ranks.solve("nmf_toolbox_tpu_torch.nmf_multiseed", V, k, 6, mesh="1d", maxiter=2)


def test_consensus_sweep_on_mesh(ranks):
    """The rank sweep composes with a mesh (restarts data-parallel):
    same seed -> identical stats and recommendation as unsharded."""
    rng = np.random.default_rng(10)
    W = np.kron(np.eye(3), np.ones((5, 1)))
    H = np.zeros((3, 24))
    H[np.arange(24) % 3, np.arange(24)] = 1.0
    V = W @ H + 0.01 * rng.random((15, 24))
    out = ranks.run(consensus, V, "1d", ranks=(2, 3, 4), n_seeds=8, maxiter=80,
                    seed=3, dtype=np.float64)
    assert all(o[0] == out[0][0] for o in out)
    rec, stats = out[0]
    a = tt.consensus_stability(V, ranks=(2, 3, 4), n_seeds=8, maxiter=80, seed=3,
                               dtype=np.float64, **CPU)
    assert rec == a.recommended
    for (cons, coph, cost), sa in zip(stats, a.stats):
        np.testing.assert_allclose(cons, sa.consensus)
        assert coph == pytest.approx(sa.cophenetic, abs=1e-9)
        assert cost == pytest.approx(sa.mean_cost, rel=1e-9)


# ---------------------------------------------------------------------------
# Front ends: the estimator and the CLI
# ---------------------------------------------------------------------------

def test_estimator_passes_mesh(ranks):
    X = np.random.default_rng(12).uniform(0.1, 1, (64, 32))
    out = ranks.run(estimator, X, "2d", n_components=4, max_iter=10, tol=1e-30,
                    random_state=0, dtype=np.float64, divergence="kl")
    assert_ranks_identical(out)
    from nmf_toolbox_tpu_torch.estimators import NMF
    est = NMF(4, max_iter=10, tol=1e-30, random_state=0, dtype=np.float64,
              divergence="kl", **CPU)
    H = est.fit_transform(X)
    np.testing.assert_allclose(out[0][0], est.components_, atol=1e-10)
    np.testing.assert_allclose(out[0][1], H, atol=1e-10)


def test_cli_nmf_mesh_matches_jax(ranks, tmp_path):
    """``nmf --mesh 4``: rank 0 alone writes --out and prints; the factors
    match the JAX CLI's on the same mesh size from the same inits."""
    rng = np.random.default_rng(13)
    V = rng.uniform(0.1, 1, (30, 40))
    np.save(tmp_path / "V.npy", V)
    from nmf_toolbox_tpu_torch.utils.checkpoint import save_factors
    save_factors(tmp_path / "init.npz", {"W": rng.uniform(size=(30, 4)),
                                         "H": rng.uniform(size=(4, 40))})
    args = ["nmf", str(tmp_path / "V.npy"), "--k", "4", "--maxiter", "5",
            "--dtype", "float64", "--tolerance", "1e-12",
            "--resume", str(tmp_path / "init.npz")]
    out = ranks.run(run_cli, args + ["--mesh", "4", "--device", "cpu",
                                  "--out", str(tmp_path / "t.npz")])
    assert [o[0] for o in out] == [0] * 4
    assert out[0][1] and not any(o[1] for o in out[1:])
    from nmf_toolbox_tpu import cli as jcli
    assert jcli.main(args + ["--mesh", "4", "--out", str(tmp_path / "j.npz")]) == 0
    with np.load(tmp_path / "t.npz") as t, np.load(tmp_path / "j.npz") as j:
        np.testing.assert_allclose(t["W"], j["W"], atol=1e-10)
        np.testing.assert_allclose(t["H"], j["H"], atol=1e-10)
