"""The port's checkpoint module (``nmf_toolbox_tpu_torch.utils.checkpoint``)
against the JAX package's, and chunked runs against one call.

Mirrors tests/test_checkpointed_run.py (13 tests) and the two checkpoint
tests of tests/test_utils.py in f64 on the CPU, adds extrapolated HALS,
and crosses checkpoint files between the packages in both directions.

Chunked runs of nmf, nmfsc, cnmfsc, HALS (plain and extrapolated) and
symnmf are bit-identical to one call: the port's nmf keeps W_init columns
that are unit-norm to rounding as they are, where the JAX package
re-normalizes them at entry (nmf.m:132-134) and its chunked nmf drifts by
an ulp per boundary.  Chunked cnmf and nmf2d re-normalize at entry in
both packages and agree with one call to rounding.  A crash-resumed run
is bit-identical to the same chunks run in one process: the file round
trip is lossless.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False

import nmf_toolbox_tpu as jt  # noqa: E402
import nmf_toolbox_tpu_torch as tt  # noqa: E402
from nmf_toolbox_tpu.utils import checkpoint as jck  # noqa: E402
from nmf_toolbox_tpu_torch.interop import load_factors_npz  # noqa: E402
from nmf_toolbox_tpu_torch.utils import checkpoint as tck  # noqa: E402
from nmf_toolbox_tpu_torch.utils.checkpoint import run_checkpointed  # noqa: E402

RTOL = 1e-9     # the port against the JAX package, f64
CHUNK_RTOL = 1e-12  # chunked cnmf/nmf2d against one call, f64
F64 = {"dtype": np.float64, "device": "cpu"}


def host(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def close(a, b, rtol=RTOL):
    a, b = host(a), host(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * np.max(np.abs(b)))


def same(a, b):
    assert torch.equal(a, b) if torch.is_tensor(a) else np.array_equal(a, b)


def test_chunked_equals_continuous(tmp_path):
    rng = np.random.default_rng(0)
    V = rng.uniform(0.1, 1, (30, 40))
    W0 = rng.uniform(size=(30, 4))
    H0 = rng.uniform(size=(4, 40))
    ref = tt.nmf(V, 4, W_init=W0, H_init=H0, maxiter=40, tolerance=1e-30, **F64)
    res = run_checkpointed(tt.nmf, V, 4, total_iters=40, chunk=10,
                           path=tmp_path / "run.npz", W_init=W0, H_init=H0,
                           tolerance=1e-30, **F64)
    same(res.W, ref.W)
    same(res.H, ref.H)
    same(res.cost, ref.cost)
    assert len(res.cost) == 40 and res.n_iters == 40
    assert res.W.device.type == "cpu"
    jx = jt.nmf(V, 4, W_init=W0, H_init=H0, maxiter=40, tolerance=1e-30,
                dtype=np.float64)
    close(res.W, jx.W)
    close(res.H, jx.H)


def test_crash_resume(tmp_path):
    rng = np.random.default_rng(1)
    V = rng.uniform(0.1, 1, (25, 30))
    W0 = rng.uniform(size=(25, 3))
    H0 = rng.uniform(size=(3, 30))
    kw = dict(W_init=W0, H_init=H0, tolerance=1e-30, **F64)
    # "crash" after 2 chunks: run only 20 of 60 iterations, then resume to
    # 60 from the file alone
    run_checkpointed(tt.nmf, V, 3, total_iters=20, chunk=10,
                     path=tmp_path / "run.npz", **kw)
    res = run_checkpointed(tt.nmf, V, 3, total_iters=60, chunk=10,
                           path=tmp_path / "run.npz", **kw)
    whole = run_checkpointed(tt.nmf, V, 3, total_iters=60, chunk=10,
                             path=tmp_path / "whole.npz", **kw)
    same(res.W, whole.W)
    same(res.H, whole.H)
    same(res.cost, whole.cost)
    ref = tt.nmf(V, 3, maxiter=60, **kw)
    same(res.W, ref.W)
    same(res.H, ref.H)
    assert len(res.cost) == 60


def test_convergence_stops_chunking(tmp_path):
    rng = np.random.default_rng(2)
    V = rng.uniform(0.1, 1, (20, 25))
    res = run_checkpointed(tt.nmf, V, 3, total_iters=500, chunk=100,
                           path=tmp_path / "c.npz", tolerance=1e-2, seed=3, **F64)
    assert res.converged
    assert len(res.cost) < 500


def test_resume_when_already_complete(tmp_path):
    """A finished run returns the saved state as a port Result."""
    rng = np.random.default_rng(3)
    V = rng.uniform(0.1, 1, (15, 20))
    p = tmp_path / "done.npz"
    a = run_checkpointed(tt.nmf, V, 3, total_iters=8, chunk=4, path=p,
                         seed=1, tolerance=1e-30, **F64)
    b = run_checkpointed(tt.nmf, V, 3, total_iters=8, chunk=4, path=p,
                         seed=1, tolerance=1e-30, **F64)
    assert isinstance(b, tt.Result) and b.converged and b.n_iters == 8
    assert torch.is_tensor(b.W) and b.W.device.type == "cpu"
    same(b.W, a.W)
    same(b.cost, a.cost)
    assert b.final_cost > 0


def test_chunk_of_one_early_stops(tmp_path):
    """chunk=1 still honors the tolerance (the driver checks at the
    boundary)."""
    rng = np.random.default_rng(4)
    V = rng.uniform(0.1, 1, (20, 25))
    res = run_checkpointed(tt.nmf, V, 3, total_iters=300, chunk=1,
                           path=tmp_path / "one.npz", tolerance=1e-2, seed=3, **F64)
    ref = tt.nmf(V, 3, maxiter=300, tolerance=1e-2, seed=3, **F64)
    assert res.converged
    assert abs(len(res.cost) - len(ref.cost)) <= 1


@pytest.mark.parametrize("method,dtype", [("gram", np.float64), ("naive", np.float64),
                                          ("fused", np.float32)])
def test_chunked_nmf_bit_exact_every_method(tmp_path, method, dtype):
    """Every nmf method continues bit for bit across chunks, f32 (fused:
    the kernels' plain versions on the CPU) and f64; a user W_init that is
    not normalized is still divided as the reference divides it."""
    rng = np.random.default_rng(11)
    V = rng.uniform(0.1, 1, (40, 30)).astype(dtype)
    W0 = rng.uniform(size=(40, 5)).astype(dtype)
    H0 = rng.uniform(size=(5, 30)).astype(dtype)
    div = "euclidean" if method == "gram" else "kl"
    kw = dict(W_init=W0, H_init=H0, method=method, divergence=div, tolerance=1e-30,
              device="cpu")
    ref = tt.nmf(V, 5, maxiter=16, **kw)
    res = run_checkpointed(tt.nmf, V, 5, total_iters=16, chunk=5,
                           path=tmp_path / "n.npz", **kw)
    same(res.W, ref.W)
    same(res.H, ref.H)
    same(res.cost, ref.cost)
    W0n = W0 / np.sqrt((W0.astype(np.float64) ** 2).sum(0, keepdims=True)).astype(dtype)
    first = tt.nmf(V, 5, maxiter=1, **kw)
    again = tt.nmf(V, 5, maxiter=1, **{**kw, "W_init": torch.from_numpy(W0) * 3})
    close(first.W, again.W, 1e-6 if dtype == np.float32 else 1e-14)
    assert not np.allclose(W0, W0n)


def test_total_iterations_reported(tmp_path):
    rng = np.random.default_rng(5)
    V = rng.uniform(0.1, 1, (15, 18))
    res = run_checkpointed(tt.nmf, V, 2, total_iters=12, chunk=4,
                           path=tmp_path / "t.npz", tolerance=1e-30, seed=1, **F64)
    assert res.n_iters == 12 and len(res.cost) == 12
    raw = tck.load_factors(tmp_path / "t.npz", as_inits=False)
    assert int(raw["extra__iters_done"]) == 12 and raw["extra__cost_so_far"].shape == (12,)


def test_chunked_cnmf_exact(tmp_path):
    rng = np.random.default_rng(6)
    V = rng.uniform(0.1, 1, (16, 30))
    W0 = rng.uniform(0.1, 1, (16, 3, 2))
    H0 = rng.uniform(0.1, 1, (3, 30))
    ref = tt.cnmf(V, 3, 2, W_init=W0, H_init=H0, maxiter=18, tolerance=1e-30, **F64)
    res = run_checkpointed(tt.cnmf, V, 3, 2, total_iters=18, chunk=6,
                           path=tmp_path / "c.npz", W_init=W0, H_init=H0,
                           tolerance=1e-30, **F64)
    close(res.W, ref.W, CHUNK_RTOL)
    close(res.H, ref.H, CHUNK_RTOL)
    np.testing.assert_allclose(res.cost, ref.cost, rtol=CHUNK_RTOL)
    jx = jt.cnmf(V, 3, 2, W_init=W0, H_init=H0, maxiter=18, tolerance=1e-30,
                 dtype=np.float64)
    close(res.W, jx.W)


def _nmfsc_problem(seed, m, n, k, T=None):
    rng = np.random.default_rng(seed)
    V = rng.uniform(0.1, 1, (m, n))
    W0 = rng.uniform(size=(m, k) if T is None else (m, k, T))
    H0 = rng.uniform(size=(k, n))
    return V, W0, H0 / np.sqrt((H0 ** 2).sum(1, keepdims=True))


def test_chunked_nmfsc_bit_exact(tmp_path):
    """The line-search stepsizes ride through resume_state and the file:
    chunked nmfsc is bit-identical to one call, and to the JAX package's
    one call within RTOL."""
    V, W0, H0 = _nmfsc_problem(7, 30, 40, 4)
    kw = dict(W_sparsity=0.5, H_sparsity=0.6, tolerance=1e-30)
    ref = tt.nmfsc(V, 4, W_init=W0, H_init=H0, maxiter=24, **kw, **F64)
    res = run_checkpointed(tt.nmfsc, V, 4, total_iters=24, chunk=7,
                           path=tmp_path / "sc.npz", W_init=W0, H_init=H0,
                           **kw, **F64)
    same(res.W, ref.W)
    same(res.H, ref.H)
    same(res.cost, ref.cost)
    jx = jt.nmfsc(V, 4, W_init=W0, H_init=H0, maxiter=24, dtype=np.float64, **kw)
    close(res.W, jx.W)
    np.testing.assert_allclose(res.cost, np.asarray(jx.cost), rtol=RTOL)


def test_chunked_nmfsc_crash_resume_bit_exact(tmp_path):
    """Fresh-process resume: the stepsizes come back from the npz."""
    V, W0, H0 = _nmfsc_problem(8, 25, 30, 3)
    kw = dict(W_sparsity=0.4, H_sparsity=0.5, tolerance=1e-30, **F64)
    p = tmp_path / "sc.npz"
    run_checkpointed(tt.nmfsc, V, 3, total_iters=10, chunk=5, path=p,
                     W_init=W0, H_init=H0, **kw)
    res = run_checkpointed(tt.nmfsc, V, 3, total_iters=30, chunk=5, path=p,
                           W_init=W0, H_init=H0, **kw)
    ref = tt.nmfsc(V, 3, W_init=W0, H_init=H0, maxiter=30, **kw)
    same(res.W, ref.W)
    same(res.H, ref.H)


def test_chunked_cnmfsc_bit_exact(tmp_path):
    """cnmfsc carries a per-frame stepsize vector (cnmfsc.m:147)."""
    rng = np.random.default_rng(9)
    V = rng.uniform(0.1, 1, (20, 28))
    W0 = rng.uniform(size=(20, 3, 3))
    H0 = rng.uniform(size=(3, 28))
    H0 = H0 / np.sqrt((H0 ** 2).sum(1, keepdims=True))
    kw = dict(H_sparsity=0.5, tolerance=1e-30, **F64)
    ref = tt.cnmfsc(V, 3, 3, W_init=W0, H_init=H0, maxiter=18, **kw)
    res = run_checkpointed(tt.cnmfsc, V, 3, 3, total_iters=18, chunk=5,
                           path=tmp_path / "csc.npz", W_init=W0, H_init=H0, **kw)
    assert ref.n_iters == 18
    same(res.W, ref.W)
    same(res.H, ref.H)
    same(res.cost, ref.cost)
    # the file holds the per-frame vector, as the JAX package writes it
    raw = tck.load_factors(tmp_path / "csc.npz", as_inits=False)
    assert raw["extra__resume_step_w"].shape == (3,)


def test_manual_resume_state_round_trip():
    """Two calls threading resume_state reproduce one call exactly."""
    V, W0, H0 = _nmfsc_problem(10, 22, 26, 3)
    kw = dict(W_sparsity=0.5, H_sparsity=0.5, tolerance=1e-30, **F64)
    ref = tt.nmfsc(V, 3, W_init=W0, H_init=H0, maxiter=12, **kw)
    a = tt.nmfsc(V, 3, W_init=W0, H_init=H0, maxiter=5, **kw)
    b = tt.nmfsc(V, 3, W_init=a.W, H_init=a.H, maxiter=7,
                 resume_state=a.resume_state, **kw)
    same(b.W, ref.W)
    same(b.H, ref.H)


def test_chunked_nmf2d_exact(tmp_path):
    rng = np.random.default_rng(7)
    V = rng.uniform(0.1, 1, (14, 24))
    W0 = rng.uniform(0.1, 1, (14, 2, 2))
    H0 = rng.uniform(0.1, 1, (2, 24, 3))
    kw = dict(W_init=W0, H_init=H0, tolerance=1e-30, **F64)
    ref = tt.nmf2d(V, 2, 2, 3, maxiter=15, **kw)
    res = run_checkpointed(tt.nmf2d, V, 2, 2, 3, total_iters=15, chunk=5,
                           path=tmp_path / "d.npz", **kw)
    close(res.W, ref.W, CHUNK_RTOL)
    close(res.H, ref.H, CHUNK_RTOL)


def test_chunked_symnmf_exact(tmp_path):
    rng = np.random.default_rng(8)
    B = rng.uniform(0.1, 1, (18, 3))
    A = B @ B.T + 0.05 * rng.uniform(size=(18, 18))
    A = (A + A.T) / 2
    H0 = rng.uniform(0.1, 1, (18, 3))
    ref = tt.symnmf(A, 3, H_init=H0, maxiter=15, tolerance=1e-30, **F64)
    res = run_checkpointed(tt.symnmf, A, 3, total_iters=15, chunk=5,
                           path=tmp_path / "s.npz", H_init=H0, tolerance=1e-30, **F64)
    same(res.H, ref.H)


@pytest.mark.parametrize("extrapolate", [False, True])
def test_chunked_hals_bit_exact(tmp_path, extrapolate):
    """Extrapolated HALS carries Wy/Hy/beta through resume_state: as
    tensors between chunks, and through the file (and
    interop.resume_state_from_numpy) after a crash."""
    rng = np.random.default_rng(11)
    V = rng.uniform(0.1, 1, (24, 30))
    W0 = rng.uniform(size=(24, 3))
    H0 = rng.uniform(size=(3, 30))
    kw = dict(W_init=W0, H_init=H0, extrapolate=extrapolate, tolerance=1e-30, **F64)
    ref = tt.nmf_hals(V, 3, maxiter=20, **kw)
    res = run_checkpointed(tt.nmf_hals, V, 3, total_iters=20, chunk=6,
                           path=tmp_path / "h.npz", **kw)
    same(res.W, ref.W)
    same(res.H, ref.H)
    same(res.cost, ref.cost)
    p = tmp_path / "crash.npz"
    run_checkpointed(tt.nmf_hals, V, 3, total_iters=8, chunk=4, path=p, **kw)
    res2 = run_checkpointed(tt.nmf_hals, V, 3, total_iters=20, chunk=4, path=p, **kw)
    same(res2.W, ref.W)
    same(res2.H, ref.H)
    raw = tck.load_factors(p, as_inits=False)
    assert ("extra__resume_Wy" in raw) == extrapolate
    jx = jt.nmf_hals(V, 3, maxiter=20, W_init=W0, H_init=H0, extrapolate=extrapolate,
                     tolerance=1e-30, dtype=np.float64)
    close(res.W, jx.W)


def test_checkpoint_roundtrip(tmp_path):
    rng = np.random.default_rng(2)
    V = rng.uniform(0.1, 1, (20, 30))
    res = tt.nmf(V, 4, maxiter=10, seed=1, **F64)
    p = tmp_path / "ckpt.npz"
    tck.save_factors(p, res)
    kw = tck.load_factors(p)
    assert set(kw) == {"W_init", "H_init"}
    assert all(isinstance(v, np.ndarray) for v in kw.values())
    res2 = tt.nmf(V, 4, maxiter=5, **F64, **kw)
    assert res2.cost[0] <= res.cost[-1] + 1e-9
    raw = tck.load_factors(p, as_inits=False)
    np.testing.assert_array_equal(raw["cost"], res.cost)
    np.testing.assert_array_equal(raw["W"], host(res.W))


def test_checkpoint_multisource(tmp_path):
    rng = np.random.default_rng(3)
    V = rng.uniform(0.1, 1, (20, 30))
    res = tt.nmf(V, [3, 2], maxiter=5, seed=1, **F64)
    p = tmp_path / "ms.npz"
    tck.save_factors(p, res)
    kw = tck.load_factors(p)
    assert isinstance(kw["W_init"], list) and len(kw["W_init"]) == 2
    res2 = tt.nmf(V, [3, 2], maxiter=3, **F64, **kw)
    assert np.all(np.isfinite(res2.cost))


def test_jax_checkpoint_resumes_in_port(tmp_path):
    """A file the JAX package's run_checkpointed wrote resumes in the
    port's to the JAX continuation: nmfsc's stepsizes and extrapolated
    HALS's momentum (NumPy in the file) included."""
    V, W0, H0 = _nmfsc_problem(12, 24, 30, 3)
    kw = dict(W_sparsity=0.5, H_sparsity=0.5, tolerance=1e-30)
    p = tmp_path / "sc.npz"
    jck.run_checkpointed(jt.nmfsc, V, 3, total_iters=8, chunk=4, path=p,
                         W_init=W0, H_init=H0, dtype=np.float64, **kw)
    res = run_checkpointed(tt.nmfsc, V, 3, total_iters=20, chunk=4, path=p,
                           W_init=W0, H_init=H0, **kw, **F64)
    jx = jt.nmfsc(V, 3, W_init=W0, H_init=H0, maxiter=20, dtype=np.float64, **kw)
    close(res.W, jx.W)
    close(res.H, jx.H)
    np.testing.assert_allclose(res.cost, np.asarray(jx.cost), rtol=RTOL)

    hk = dict(W_init=W0, H_init=H0, extrapolate=True, tolerance=1e-30)
    p = tmp_path / "hals.npz"
    jck.run_checkpointed(jt.nmf_hals, V, 3, total_iters=6, chunk=3, path=p,
                         dtype=np.float64, **hk)
    res = run_checkpointed(tt.nmf_hals, V, 3, total_iters=15, chunk=3, path=p,
                           **hk, **F64)
    jx = jt.nmf_hals(V, 3, maxiter=15, dtype=np.float64, **hk)
    close(res.W, jx.W)
    close(res.H, jx.H)


def test_port_checkpoint_loads_in_jax(tmp_path):
    """A file the port wrote loads in the JAX package's load_factors and
    in interop.load_factors_npz: per-source lists and cmfwisa's complex P
    included; a port run_checkpointed file resumes in the JAX one."""
    rng = np.random.default_rng(13)
    m, n = 12, 16
    V = rng.uniform(0.1, 1, (m, n)) * np.exp(1j * rng.uniform(-np.pi, np.pi, (m, n)))
    res = tt.cmfwisa(V, [2, 2], maxiter=4, seed=0, **F64)
    p = tmp_path / "cmf.npz"
    tck.save_factors(p, res)
    raw = jck.load_factors(p, as_inits=False)
    assert isinstance(raw["P"], list) and len(raw["P"]) == 2
    for s in range(2):
        assert np.iscomplexobj(raw["P"][s])
        np.testing.assert_array_equal(raw["P"][s], host(res.P[s]))
        np.testing.assert_array_equal(raw["W"][s], host(res.W[s]))
    np.testing.assert_array_equal(raw["cost"], res.cost)
    npz = load_factors_npz(p)
    assert npz["n_iters"] == res.n_iters and list(npz) [:len(res.fields)] == list(res.fields)
    assert set(jck.load_factors(p)) == {"W_init", "H_init", "P_init"}

    Vr, W0, H0 = _nmfsc_problem(14, 20, 24, 3)
    kw = dict(H_sparsity=0.5, tolerance=1e-30)
    p = tmp_path / "sc.npz"
    run_checkpointed(tt.nmfsc, Vr, 3, total_iters=6, chunk=3, path=p,
                     W_init=W0, H_init=H0, **kw, **F64)
    jr = jck.run_checkpointed(jt.nmfsc, Vr, 3, total_iters=15, chunk=3, path=p,
                              W_init=W0, H_init=H0, dtype=np.float64, **kw)
    jx = jt.nmfsc(Vr, 3, W_init=W0, H_init=H0, maxiter=15, dtype=np.float64, **kw)
    close(jr.W, jx.W)
    close(jr.H, jx.H)


def test_orbax_and_mesh_raise(tmp_path):
    """backend='orbax' writes a directory checkpoint and continues like
    npz, with a one-rank mesh too; a foreign mesh= raises a TypeError
    naming make_mesh; an unknown backend a ValueError (the sharded cases
    are tests/test_torch_checkpoint_orbax.py's)."""
    V = np.random.default_rng(15).uniform(0.1, 1, (8, 10))
    ref = run_checkpointed(tt.nmf, V, 2, total_iters=4, chunk=2,
                           path=tmp_path / "n.npz", **F64)
    res = run_checkpointed(tt.nmf, V, 2, total_iters=4, chunk=2, path=tmp_path / "o",
                           backend="orbax", **F64)
    assert (tmp_path / "o").is_dir()
    assert torch.equal(res.W, ref.W) and torch.equal(res.H, ref.H)
    from torch_mesh import one_rank
    from nmf_toolbox_tpu_torch.parallel import make_mesh
    kw = {k: v for k, v in F64.items() if k != "device"}
    with one_rank():
        res = run_checkpointed(tt.nmf, V, 2, total_iters=4, chunk=2,
                               path=tmp_path / "m", mesh=make_mesh(1, device_type="cpu"), **kw)
    assert (tmp_path / "m").is_dir()  # auto: orbax for a mesh run
    assert torch.equal(res.W, ref.W) and torch.equal(res.H, ref.H)
    with pytest.raises(TypeError, match="make_mesh"):
        run_checkpointed(tt.nmf, V, 2, total_iters=4, chunk=2,
                         path=tmp_path / "m.npz", mesh=object(), **F64)
    with pytest.raises(ValueError, match="unknown checkpoint backend"):
        run_checkpointed(tt.nmf, V, 2, total_iters=4, chunk=2,
                         path=tmp_path / "x.npz", backend="zarr", **F64)
    # the refused calls wrote nothing
    assert sorted(p.name for p in tmp_path.iterdir()) == ["m", "n.npz", "o"]
