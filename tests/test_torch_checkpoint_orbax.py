"""The port's directory checkpoints (nmf_toolbox_tpu_torch.utils.
checkpoint_orbax, on torch.distributed.checkpoint) and
``run_checkpointed(backend="orbax")``: tests/test_checkpoint_orbax.py's
eight cases.  The plain, async, nmfsc and backend cases run in this
process with no process group; the sharded ones on four Gloo ranks
(tests/torch_mesh.py) with ``make_mesh(4)``, every rank writing its own
blocks, and are held against the JAX package's orbax runs on the same
mesh shape (the two formats differ, so the results are compared, not
the files) at the JAX tests' tolerances, every rank bit-identical to
rank 0.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import nmf_toolbox_tpu as jt  # noqa: E402
import nmf_toolbox_tpu_torch as tt  # noqa: E402
from nmf_toolbox_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from nmf_toolbox_tpu.utils.checkpoint import run_checkpointed as jrun  # noqa: E402
from nmf_toolbox_tpu_torch.utils.checkpoint import run_checkpointed  # noqa: E402
from nmf_toolbox_tpu_torch.utils.checkpoint_orbax import (  # noqa: E402
    load_factors_orbax, save_factors_orbax)

from torch_mesh import Ranks, host, mesh_of, same_on_ranks  # noqa: E402

CPU = {"device": "cpu"}


@pytest.fixture(scope="module")
def ranks():
    r = Ranks(4)
    yield r
    r.close()


def _problem(seed=0, m=32, n=40, k=4):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.1, 1, (m, n)), rng.uniform(size=(m, k)),
            rng.uniform(size=(k, n)))


def test_round_trip_plain(tmp_path):
    V, W0, H0 = _problem()
    res = tt.nmf(V, 4, W_init=W0, H_init=H0, maxiter=5, tolerance=1e-30,
                 dtype=np.float64, **CPU)
    p = tmp_path / "ck"
    save_factors_orbax(p, res)
    inits = load_factors_orbax(p)
    np.testing.assert_array_equal(inits["W_init"], host(res.W))
    np.testing.assert_array_equal(inits["H_init"], host(res.H))
    raw = load_factors_orbax(p, as_inits=False)
    assert int(raw["n_iters"]) == 5 and len(raw["cost"]) == 5
    assert p.is_dir() and not (tmp_path / "ck.partial").exists()


def _sharded_save_restore(V, W0, H0, path):
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = mesh_of("1d")
    res = tt.nmf(V, 4, W_init=W0, H_init=H0, maxiter=4, tolerance=1e-30,
                 dtype=np.float64, mesh=mesh)
    save_factors_orbax(path, res, mesh=mesh, solver="nmf")
    inits = load_factors_orbax(path, mesh=mesh, solver="nmf")
    W, H = inits["W_init"], inits["H_init"]
    # restored straight into nmf's placement: W replicated on a sample
    # mesh, H sharded over its columns, each rank holding its block
    assert isinstance(W, DTensor) and isinstance(H, DTensor)
    assert list(W.placements) == [Replicate()] and list(H.placements) == [Shard(1)]
    assert tuple(H.to_local().shape) == (4, V.shape[1] // 4)
    from nmf_toolbox_tpu_torch.parallel.collectives import dtensor_whole
    same = bool(torch.equal(dtensor_whole(W), res.W) and torch.equal(dtensor_whole(H), res.H))
    ref = tt.nmf(V, 4, W_init=res.W, H_init=res.H, maxiter=3, tolerance=1e-30,
                 dtype=np.float64, mesh=mesh)
    out = tt.nmf(V, 4, maxiter=3, tolerance=1e-30, dtype=np.float64, mesh=mesh, **inits)
    return same, host(out.W), host(ref.W)


def test_sharded_save_and_placement_restore(ranks, tmp_path):
    V, W0, H0 = _problem(1)
    same, W, ref = same_on_ranks(ranks.run(_sharded_save_restore, V, W0, H0,
                                           str(tmp_path / "ck")))
    assert same
    np.testing.assert_allclose(W, ref, atol=1e-14)
    # one .distcp file per rank: each wrote its own blocks
    assert len(list((tmp_path / "ck").glob("*.distcp"))) == 4


def test_async_save_then_load(tmp_path):
    V, W0, H0 = _problem(2)
    res = tt.nmf(V, 4, W_init=W0, H_init=H0, maxiter=3, tolerance=1e-30,
                 dtype=np.float64, **CPU)
    p = tmp_path / "ck"
    save_factors_orbax(p, res, extra={"iters_done": np.asarray(3)}, wait=False)
    # load joins pending saves before reading
    raw = load_factors_orbax(p, as_inits=False)
    assert int(raw["extra__iters_done"]) == 3
    np.testing.assert_array_equal(raw["W"], host(res.W))


def _checkpointed(V, path, backend, total_iters, chunk, kind="1d", **kw):
    res = run_checkpointed(tt.nmf, V, 4, total_iters=total_iters, chunk=chunk,
                           path=path, backend=backend, mesh=mesh_of(kind), **kw)
    return host(res.W), host(res.H), np.asarray(res.cost), res.n_iters


def test_run_checkpointed_orbax_matches_npz(ranks, tmp_path):
    V, W0, H0 = _problem(3)
    kw = dict(W_init=W0, H_init=H0, tolerance=1e-30, dtype=np.float64)
    ref = same_on_ranks(ranks.run(_checkpointed, V, str(tmp_path / "run.npz"),
                                  "npz", 20, 8, **kw))
    res = same_on_ranks(ranks.run(_checkpointed, V, str(tmp_path / "run_orbax"),
                                  "orbax", 20, 8, **kw))
    np.testing.assert_allclose(res[0], ref[0], atol=1e-14)
    np.testing.assert_allclose(res[2], ref[2], atol=1e-12)
    assert res[3] == ref[3] == 20
    want = jrun(jt.nmf, V, 4, total_iters=20, chunk=8, path=tmp_path / "jax_orbax",
                backend="orbax", mesh=jmake_mesh(4), **kw)
    np.testing.assert_allclose(res[0], np.asarray(want.W), atol=1e-10)
    np.testing.assert_allclose(res[2], np.asarray(want.cost), rtol=1e-10)


def test_run_checkpointed_orbax_crash_resume(ranks, tmp_path):
    V, W0, H0 = _problem(4)
    kw = dict(W_init=W0, H_init=H0, tolerance=1e-30, dtype=np.float64)
    p = str(tmp_path / "run_orbax")
    ranks.run(_checkpointed, V, p, "orbax", 10, 5, **kw)  # the run "crashes" here
    res = same_on_ranks(ranks.run(_checkpointed, V, p, "orbax", 30, 5, **kw))
    ref = ranks.solve("nmf_toolbox_tpu_torch.nmf", V, 4, mesh="1d", maxiter=30, **kw)
    np.testing.assert_allclose(res[0], ref["W"], atol=1e-13)
    assert res[3] == 30
    want = jt.nmf(V, 4, maxiter=30, mesh=jmake_mesh(4), **kw)
    np.testing.assert_allclose(res[0], np.asarray(want.W), atol=1e-10)


@pytest.mark.parametrize("case", ["fused kl f32", "gram f64"])
def test_run_checkpointed_orbax_crash_resume_2x2(ranks, tmp_path, case):
    """chip_smoke.py phase 19's checkpoint on the 2 x 2 mesh: a run that
    crashes after 10 of 20 iterations and resumes from its directory is
    bit-identical to one uninterrupted call on the same mesh."""
    V, W0, H0 = _problem(6)
    if case == "fused kl f32":
        V, W0, H0 = (x.astype(np.float32) for x in (V, W0, H0))
        kw = dict(W_init=W0, H_init=H0, tolerance=1e-30, dtype=np.float32,
                  method="fused", divergence="kl")
    else:
        kw = dict(W_init=W0, H_init=H0, tolerance=1e-30, dtype=np.float64, method="gram")
    p = str(tmp_path / "run_orbax")
    ranks.run(_checkpointed, V, p, "orbax", 10, 5, kind="2d", **kw)  # the run "crashes" here
    res = same_on_ranks(ranks.run(_checkpointed, V, p, "orbax", 20, 5, kind="2d", **kw))
    ref = ranks.solve("nmf_toolbox_tpu_torch.nmf", V, 4, mesh="2d", maxiter=20, **kw)
    for got, want in zip(res, (ref["W"], ref["H"], ref["cost"], ref["n_iters"])):
        np.testing.assert_array_equal(got, want)


def test_auto_backend_selects_orbax_for_mesh_dir(ranks, tmp_path):
    V, W0, H0 = _problem(5)
    p = tmp_path / "auto_ck"
    ranks.run(_checkpointed, V, str(p), "auto", 6, 3, W_init=W0, H_init=H0,
              tolerance=1e-30, dtype=np.float64)
    assert p.is_dir()  # the directory layout, not an npz file
    assert (p / ".metadata").exists()


def test_nmfsc_resume_state_via_orbax(tmp_path):
    # projected-gradient stepsize state rides the checkpoint's extra group
    V, _, _ = _problem(6, m=24, n=30, k=3)
    kw = dict(W_sparsity=0.5, tolerance=1e-30, dtype=np.float64, seed=0, **CPU)
    ref = tt.nmfsc(V, 3, maxiter=12, **kw)
    res = run_checkpointed(tt.nmfsc, V, 3, total_iters=12, chunk=4,
                           path=tmp_path / "sc", backend="orbax", **kw)
    np.testing.assert_array_equal(host(res.W), host(ref.W))
    np.testing.assert_array_equal(host(res.H), host(ref.H))


def test_unknown_backend_rejected(tmp_path):
    V, W0, H0 = _problem(7)
    with pytest.raises(ValueError, match="backend"):
        run_checkpointed(tt.nmf, V, 4, total_iters=4, chunk=2,
                         path=tmp_path / "x", backend="hdf5",
                         W_init=W0, H_init=H0, **CPU)


def test_group_follows_the_process_group(tmp_path):
    """The checkpoints' own Gloo group is made anew for each default
    process group: a save and a load in a second group after the first
    was destroyed, and in no group at all, run and round-trip."""
    from nmf_toolbox_tpu_torch.utils import checkpoint_orbax as co
    from torch_mesh import one_rank
    V, W0, H0 = _problem()
    res = tt.nmf(V, 4, W_init=W0, H_init=H0, maxiter=3, tolerance=1e-30,
                 dtype=np.float64, **CPU)
    groups = []
    for i in range(2):
        with one_rank():
            save_factors_orbax(tmp_path / f"ck{i}", res)
            groups.append(co._group())
            inits = load_factors_orbax(tmp_path / f"ck{i}")
            np.testing.assert_array_equal(inits["W_init"], host(res.W))
    assert groups[0] is not groups[1] and co._group() is None
    save_factors_orbax(tmp_path / "ck2", res)
    np.testing.assert_array_equal(load_factors_orbax(tmp_path / "ck2")["H_init"],
                                  host(res.H))
