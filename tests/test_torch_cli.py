"""The port's command line (``nmf_toolbox_tpu_torch.cli``, ``python -m
nmf_toolbox_tpu_torch``, the ``nmf-tpu-torch`` script) against the JAX
package's.  Mirrors tests/test_cli.py (38 tests) on the CPU with
``--device cpu``.  Most cases run in-process through ``cli.main(argv)``;
two go through ``python -m nmf_toolbox_tpu_torch`` to cover
``__main__``.  The ``--mesh`` cases run in a one-rank process group in
this process, and ``--pick-rank --mesh`` on two Gloo ranks
(tests/torch_mesh.py); without torchrun ``--mesh`` is refused cleanly.  For ``nmf``,
``cnmf``, ``encode`` and ``--checkpoint-every`` the saved npz is compared
with the JAX CLI's, both in f64: with the same inits (``--resume`` of one
init file) within rtol 1e-9, and for ``encode``, whose H init each
package draws from its own generator, at the shared optimum of the convex
fixed-W problem."""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False

from nmf_toolbox_tpu import cli as jcli  # noqa: E402
from nmf_toolbox_tpu_torch import cli  # noqa: E402
from nmf_toolbox_tpu_torch.utils.checkpoint import load_factors, save_factors  # noqa: E402

REPO = str(pathlib.Path(__file__).resolve().parents[1])
RTOL = 1e-9


class Run:
    def __init__(self, returncode, stdout, stderr):
        self.returncode, self.stdout, self.stderr = returncode, stdout, stderr


@pytest.fixture
def run_cli(capsys):
    """cli.main in this process, on the CPU; returns code and output."""
    def run(args, device=True):
        rc = cli.main(list(args) + (["--device", "cpu"] if device else []))
        out = capsys.readouterr()
        return Run(rc, out.out, out.err)
    return run


@pytest.fixture
def run_jax(capsys):
    def run(args):
        rc = jcli.main(list(args))
        out = capsys.readouterr()
        assert rc == 0, out.err[-500:]
        return json.loads(out.out.strip().splitlines()[-1])
    return run


def run_module(args):
    """python -m nmf_toolbox_tpu_torch in a subprocess."""
    env = {"PYTHONPATH": REPO, "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "HOME": os.environ.get("HOME", REPO), "OMP_NUM_THREADS": "2"}
    return subprocess.run([sys.executable, "-m", "nmf_toolbox_tpu_torch"] + args,
                          capture_output=True, text=True, cwd=REPO, env=env,
                          timeout=300)


def summary(r):
    assert r.returncode == 0, r.stderr[-800:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def refused(r, *words):
    assert r.returncode == 2, (r.returncode, r.stderr[-500:])
    assert r.stderr.startswith("error:"), r.stderr[:300]
    assert "Traceback" not in r.stderr
    for w in words:
        assert w in r.stderr, (w, r.stderr)


def close(a, b, rtol=RTOL):
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * np.max(np.abs(b)))


@pytest.fixture(scope="module")
def matrix_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("cli") / "V.npy"
    rng = np.random.default_rng(0)
    np.save(p, rng.uniform(0.1, 1, (30, 40)).astype(np.float32))
    return str(p)


@pytest.fixture(scope="module")
def init_file(tmp_path_factory):
    """W_init (30, 4) and H_init (4, 40) for matrix_file, in f64."""
    p = tmp_path_factory.mktemp("cli") / "init.npz"
    rng = np.random.default_rng(1)
    save_factors(p, {"W": rng.uniform(size=(30, 4)), "H": rng.uniform(size=(4, 40))})
    return str(p)


def test_cli_nmf(matrix_file, init_file, tmp_path, run_jax):
    """Through python -m nmf_toolbox_tpu_torch; the npz equals the JAX
    CLI's for the same inits."""
    out = str(tmp_path / "f.npz")
    args = ["nmf", matrix_file, "--k", "4", "--maxiter", "10", "--divergence", "kl",
            "--dtype", "float64", "--resume", init_file]
    s = summary(run_module(args + ["--out", out, "--device", "cpu"]))
    assert s["iterations"] == 10 and s["k"] == 4
    assert load_factors(out)["W_init"].shape == (30, 4)
    js = run_jax(args + ["--out", str(tmp_path / "j.npz")])
    with np.load(out) as t, np.load(tmp_path / "j.npz") as j:
        assert sorted(t.files) == sorted(j.files)
        for key in ("W", "H", "cost"):
            close(t[key], j[key])
    assert s["final_cost"] == pytest.approx(js["final_cost"], rel=RTOL)


def test_cli_cnmf_requires_context(matrix_file, tmp_path, run_cli):
    r = run_cli(["cnmf", matrix_file, "--k", "3", "--out", str(tmp_path / "x.npz")])
    refused(r, "context-len")


def test_cli_cnmf_matches_jax(matrix_file, tmp_path, run_cli, run_jax):
    rng = np.random.default_rng(2)
    init = str(tmp_path / "init.npz")
    save_factors(init, {"W": rng.uniform(0.1, 1, (30, 3, 2)),
                        "H": rng.uniform(0.1, 1, (3, 40))})
    args = ["cnmf", matrix_file, "--k", "3", "--context-len", "2", "--maxiter", "8",
            "--dtype", "float64", "--resume", init]
    summary(run_cli(args + ["--out", str(tmp_path / "t.npz")]))
    run_jax(args + ["--out", str(tmp_path / "j.npz")])
    with np.load(tmp_path / "t.npz") as t, np.load(tmp_path / "j.npz") as j:
        for key in ("W", "H", "cost"):
            close(t[key], j[key])


def test_cli_resume(matrix_file, tmp_path, run_cli):
    out1 = str(tmp_path / "a.npz")
    out2 = str(tmp_path / "b.npz")
    summary(run_cli(["nmf", matrix_file, "--k", "3", "--maxiter", "5", "--out", out1]))
    s = summary(run_cli(["nmf", matrix_file, "--k", "3", "--maxiter", "5",
                         "--resume", out1, "--out", out2]))
    assert s["iterations"] == 5


def test_cli_checkpointed(matrix_file, init_file, tmp_path, run_cli, run_jax):
    out = str(tmp_path / "c.npz")
    args = ["nmf", matrix_file, "--k", "4", "--maxiter", "12", "--checkpoint-every", "4",
            "--dtype", "float64", "--resume", init_file, "--tolerance", "1e-30"]
    s = summary(run_cli(args + ["--out", out]))
    assert s["iterations"] >= 4
    run_jax(args + ["--out", str(tmp_path / "j.npz")])
    with np.load(out) as t, np.load(tmp_path / "j.npz") as j:
        assert sorted(t.files) == sorted(j.files)
        assert int(t["extra__iters_done"]) == int(j["extra__iters_done"]) == 12
        for key in ("W", "H", "cost", "extra__cost_so_far"):
            close(t[key], j[key])


def test_cli_checkpointed_rerun_and_totals(matrix_file, tmp_path, run_cli):
    out = str(tmp_path / "r.npz")
    args = ["nmf", matrix_file, "--k", "3", "--maxiter", "8", "--checkpoint-every", "4",
            "--out", out]
    assert summary(run_cli(args))["iterations"] == 8
    assert summary(run_cli(args))["converged"] is True


def test_cli_mesh(matrix_file, tmp_path, run_cli):
    """--mesh runs in a process group (a one-rank one here; torchrun's
    are tests/test_torch_distributed.py's), bit-identical to no mesh,
    for nmf and for lnmf, whose mesh= this port once refused.  Through
    python -m without torchrun it is refused cleanly; encode --streaming
    --mesh too, as the JAX CLI refuses it."""
    from torch_mesh import one_rank
    for solver in ("nmf", "lnmf"):
        args = [solver, matrix_file, "--k", "4", "--maxiter", "5"]
        summary(run_cli(args + ["--out", str(tmp_path / "s.npz")]))
        with one_rank():
            s = summary(run_cli(args + ["--mesh", "1", "--out", str(tmp_path / "m.npz")]))
        assert s["iterations"] == 5 and s["solver"] == solver
        a, b = load_factors(tmp_path / "s.npz"), load_factors(tmp_path / "m.npz")
        for key in ("W_init", "H_init"):
            np.testing.assert_array_equal(a[key], b[key])
    r = run_module(args + ["--mesh", "8", "--out", str(tmp_path / "x.npz"),
                           "--device", "cpu"])
    refused(r, "torchrun")
    w = str(tmp_path / "W.npy")
    np.save(w, np.ones((30, 2), np.float32))
    with one_rank():
        refused(run_cli(["encode", matrix_file, "--dict", w, "--streaming", "--mesh", "1",
                         "--out", str(tmp_path / "x.npz")]), "single-device")
    assert not (tmp_path / "x.npz").exists()


def test_cli_streaming(matrix_file, tmp_path, run_cli):
    out = str(tmp_path / "s.npz")
    s = summary(run_cli(["nmf", matrix_file, "--k", "3", "--maxiter", "4", "--streaming",
                         "--block-size", "16", "--out", out]))
    assert s["iterations"] >= 1
    assert load_factors(out)["W_init"].shape == (30, 3)


def test_cli_streaming_rejects_other_solvers(matrix_file, tmp_path, run_cli):
    r = run_cli(["lnmf", matrix_file, "--k", "3", "--streaming",
                 "--out", str(tmp_path / "x.npz")])
    refused(r, "streaming")


def test_cli_init_flag(matrix_file, tmp_path, run_cli):
    out = str(tmp_path / "f.npz")
    s = summary(run_cli(["nmf", matrix_file, "--k", "4", "--init", "nndsvdar",
                         "--maxiter", "5", "--out", out]))
    assert s["iterations"] == 5
    summary(run_cli(["nmf_hals", matrix_file, "--k", "4", "--init", "nndsvda",
                     "--maxiter", "5", "--out", out]))
    refused(run_cli(["seminmf", matrix_file, "--k", "4", "--init", "nndsvda",
                     "--maxiter", "5", "--out", out]), "only supported")
    refused(run_cli(["nmf", matrix_file, "--k", "4", "--init", "nndsvda",
                     "--resume", out, "--maxiter", "5", "--out", out]), "--resume")
    refused(run_cli(["nmf_hals", matrix_file, "--k", "4", "--divergence", "kl",
                     "--maxiter", "5", "--out", out]), "does not support")


def test_cli_weights(matrix_file, tmp_path, run_cli):
    V = np.load(matrix_file)
    M = (np.random.default_rng(0).uniform(size=V.shape) < 0.8).astype(np.float32)
    mfile = str(tmp_path / "M.npy")
    np.save(mfile, M)
    summary(run_cli(["nmf", matrix_file, "--k", "3", "--weights", mfile,
                     "--maxiter", "5", "--out", str(tmp_path / "w.npz")]))
    summary(run_cli(["nmf_hals", matrix_file, "--k", "3", "--weights", mfile,
                     "--maxiter", "5", "--out", str(tmp_path / "w2.npz")]))
    refused(run_cli(["lnmf", matrix_file, "--k", "3", "--weights", mfile,
                     "--maxiter", "2", "--out", str(tmp_path / "x.npz")]), "--weights")


def test_cli_solver_valueerror_is_clean(matrix_file, tmp_path, run_cli):
    w = str(tmp_path / "w.npy")
    np.save(w, np.ones((30, 40), np.float32))
    for solver in ("nmf", "nmf_hals"):
        refused(run_cli([solver, matrix_file, "--k", "4", "--weights", w,
                         "--inner-iters", "2", "--maxiter", "3",
                         "--out", str(tmp_path / "f.npz")]))


def test_cli_orbax_checkpoint_and_resume(matrix_file, tmp_path, run_cli):
    # --checkpoint-backend orbax writes a directory checkpoint; --resume
    # accepts that directory for a follow-on run.
    out = str(tmp_path / "ck_dir")
    s = summary(run_cli(["nmf", matrix_file, "--k", "4", "--maxiter", "6",
                         "--checkpoint-every", "3", "--checkpoint-backend", "orbax",
                         "--out", out]))
    assert s["iterations"] == 6 and pathlib.Path(out).is_dir()
    summary(run_cli(["nmf", matrix_file, "--k", "4", "--maxiter", "2",
                     "--resume", out, "--out", str(tmp_path / "f.npz")]))
    assert (tmp_path / "f.npz").exists()


def test_cli_pick_rank_consensus(tmp_path, run_cli):
    rng = np.random.default_rng(1)
    W = np.kron(np.eye(3), np.ones((10, 1)))
    H = np.zeros((3, 36))
    H[np.arange(36) % 3, np.arange(36)] = 1.0 + 0.2 * rng.random(36)
    p = tmp_path / "V.npy"
    np.save(p, (W @ H + 0.01 * rng.random((30, 36))).astype(np.float32))
    out = str(tmp_path / "f.npz")
    s = summary(run_cli(["nmf", str(p), "--pick-rank", "2,3,5", "--rank-seeds", "8",
                         "--maxiter", "10", "--out", out]))
    sel = s["rank_selection"]
    assert sel["method"] == "consensus" and s["k"] == sel["recommended"]
    assert set(sel["cophenetic"]) == {"2", "3", "5"}
    assert load_factors(out)["W_init"].shape == (30, s["k"])


def test_cli_pick_rank_svd(tmp_path, run_cli):
    rng = np.random.default_rng(2)
    p = tmp_path / "V.npy"
    np.save(p, (rng.random((40, 3)) @ rng.random((3, 50))).astype(np.float32))
    s = summary(run_cli(["nmf", str(p), "--pick-rank", "svd", "--rank-energy", "0.999",
                         "--maxiter", "5", "--out", str(tmp_path / "f.npz")]))
    assert s["rank_selection"]["method"] == "svd"
    assert s["k"] <= 3


def test_cli_pick_rank_validation(matrix_file, tmp_path, run_cli):
    out = str(tmp_path / "x.npz")
    refused(run_cli(["nmf", matrix_file, "--out", out]), "--k is required")
    refused(run_cli(["nmf", matrix_file, "--k", "3", "--pick-rank", "2,3", "--out", out]),
            "not both")


def test_cli_fix_factor_encoding(matrix_file, tmp_path, run_cli):
    dic = str(tmp_path / "dict.npz")
    summary(run_cli(["nmf", matrix_file, "--k", "4", "--maxiter", "15", "--out", dic]))
    enc = str(tmp_path / "enc.npz")
    summary(run_cli(["nmf", matrix_file, "--resume", dic, "--fix", "W", "--k", "4",
                     "--maxiter", "5", "--out", enc]))
    with np.load(dic) as d, np.load(enc) as e:
        np.testing.assert_allclose(d["W"], e["W"], rtol=1e-5)
        assert not np.array_equal(d["H"], e["H"])


def test_cli_fix_validation(matrix_file, tmp_path, run_cli):
    out = str(tmp_path / "x.npz")
    refused(run_cli(["nmf", matrix_file, "--k", "3", "--fix", "W", "--out", out]),
            "requires --resume")
    refused(run_cli(["chnmf", matrix_file, "--k", "3", "--fix", "H", "--out", out]),
            "--fix is only supported")


def test_cli_pick_rank_kl_sweep(tmp_path, run_cli):
    rng = np.random.default_rng(3)
    W = np.kron(np.eye(3), np.ones((8, 1)))
    H = np.zeros((3, 30))
    H[np.arange(30) % 3, np.arange(30)] = 1.0
    p = tmp_path / "V.npy"
    np.save(p, (W @ H + 0.01 * rng.random((24, 30))).astype(np.float32))
    s = summary(run_cli(["nmf", str(p), "--pick-rank", "2,3", "--rank-seeds", "6",
                         "--divergence", "kl", "--maxiter", "8",
                         "--out", str(tmp_path / "f.npz")]))
    assert s["rank_selection"]["sweep_divergence"] == "kl"


def test_cli_fix_encodes_different_sample_count(tmp_path, run_cli):
    rng = np.random.default_rng(4)
    W = rng.uniform(0.1, 1, (20, 3))
    old, new = tmp_path / "old.npy", tmp_path / "new.npy"
    np.save(old, (W @ rng.uniform(size=(3, 30))).astype(np.float32))
    np.save(new, (W @ rng.uniform(size=(3, 45))).astype(np.float32))
    dic = str(tmp_path / "dict.npz")
    summary(run_cli(["nmf", str(old), "--k", "3", "--maxiter", "10", "--out", dic]))
    enc = str(tmp_path / "enc.npz")
    summary(run_cli(["nmf", str(new), "--resume", dic, "--fix", "W", "--k", "3",
                     "--maxiter", "10", "--out", enc]))
    with np.load(enc) as e:
        assert e["H"].shape == (3, 45)


def test_cli_pick_rank_mesh_rounds_seeds(tmp_path):
    """--pick-rank with --mesh rounds --rank-seeds up to the mesh's
    sample-axis multiple instead of hard-failing (two Gloo ranks)."""
    from torch_mesh import Ranks, run_cli as rank_cli
    rng = np.random.default_rng(5)
    W = np.kron(np.eye(3), np.ones((8, 1)))
    H = np.zeros((3, 32))
    H[np.arange(32) % 3, np.arange(32)] = 1.0
    p = tmp_path / "V.npy"
    np.save(p, (W @ H + 0.01 * rng.random((24, 32))).astype(np.float32))
    ranks = Ranks(2)
    try:
        out = ranks.run(rank_cli, ["nmf", str(p), "--pick-rank", "2,3",
                                   "--rank-seeds", "5", "--mesh", "2", "--maxiter", "8",
                                   "--device", "cpu", "--out", str(tmp_path / "f.npz")])
    finally:
        ranks.close()
    assert [rc for rc, _ in out] == [0, 0]
    summary = json.loads(out[0][1].strip().splitlines()[-1])
    assert summary["rank_selection"]["n_seeds"] == 6


def test_cli_streaming_rejects_pick_rank(tmp_path, run_cli):
    p = tmp_path / "V.npy"
    np.save(p, np.random.default_rng(6).random((20, 30)).astype(np.float32))
    refused(run_cli(["nmf", str(p), "--streaming", "--pick-rank", "2,3",
                     "--out", str(tmp_path / "x.npz")]), "--pick-rank")


def test_cli_encode(tmp_path, run_cli, run_jax):
    """Train, then batch-encode against the checkpoint and a raw .npy W.
    The KL encode of both packages lands on the fixed-W optimum."""
    rng = np.random.default_rng(12)
    m, n, k, B = 20, 25, 3, 4
    V = rng.uniform(0.1, 1, (m, n)).astype(np.float32)
    v_file = str(tmp_path / "V.npy")
    np.save(v_file, V)
    train_out = str(tmp_path / "train.npz")
    summary(run_cli(["nmf", v_file, "--k", str(k), "--maxiter", "15", "--out", train_out]))
    Vs = rng.uniform(0.1, 1, (B, m, 18)).astype(np.float32)
    vs_file = str(tmp_path / "Vs.npy")
    np.save(vs_file, Vs)
    enc_out = str(tmp_path / "enc.npz")
    s = summary(run_cli(["encode", vs_file, "--dict", train_out, "--maxiter", "12",
                         "--h-sparsity", "0.1", "--divergence", "kl", "--out", enc_out]))
    assert s["k"] == k and s["iterations"] == 12
    with np.load(enc_out) as z:
        assert z["H"].shape == (B, k, 18) and z["cost"].shape == (B, 12)
        assert z["W"].shape == (m, k)
    w_file = str(tmp_path / "W.npy")
    with np.load(train_out) as z:
        np.save(w_file, z["W"])
    summary(run_cli(["encode", vs_file, "--dict", w_file, "--maxiter", "5",
                     "--out", str(tmp_path / "enc2.npz")]))
    args = ["encode", vs_file, "--dict", w_file, "--maxiter", "3000", "--divergence", "kl",
            "--dtype", "float64"]
    summary(run_cli(args + ["--out", str(tmp_path / "t.npz")]))
    run_jax(args + ["--out", str(tmp_path / "j.npz")])
    with np.load(tmp_path / "t.npz") as t, np.load(tmp_path / "j.npz") as j:
        assert sorted(t.files) == sorted(j.files)
        close(t["W"], j["W"])
        np.testing.assert_allclose(t["cost"][:, -1], j["cost"][:, -1], rtol=1e-8)
        close(t["H"], j["H"], 1e-3)


def test_cli_encode_validation(tmp_path, run_cli):
    rng = np.random.default_rng(13)
    Vs = rng.uniform(0.1, 1, (2, 10, 12)).astype(np.float32)
    vs_file = str(tmp_path / "Vs.npy")
    np.save(vs_file, Vs)
    w_file = str(tmp_path / "W.npy")
    np.save(w_file, rng.uniform(size=(10, 3)).astype(np.float32))
    out = str(tmp_path / "o.npz")
    refused(run_cli(["encode", vs_file, "--maxiter", "3", "--out", out]), "--dict")
    refused(run_cli(["encode", vs_file, "--dict", w_file, "--k", "3", "--out", out]),
            "does not support")
    refused(run_cli(["encode", vs_file, "--dict", w_file, "--fix", "W", "--out", out]),
            "does not support")
    v2 = str(tmp_path / "V2.npy")
    np.save(v2, Vs[0])
    refused(run_cli(["encode", v2, "--dict", w_file, "--out", out]), "B, m, n")


def test_cli_encode_convolutive(tmp_path, run_cli):
    rng = np.random.default_rng(14)
    m, n, k, T, B = 12, 16, 2, 3, 2
    w_file = str(tmp_path / "Wc.npy")
    np.save(w_file, rng.uniform(0.1, 1, (m, k, T)).astype(np.float32))
    vs_file = str(tmp_path / "Vs.npy")
    np.save(vs_file, rng.uniform(0.1, 1, (B, m, n)).astype(np.float32))
    out = str(tmp_path / "enc.npz")
    s = summary(run_cli(["encode", vs_file, "--dict", w_file, "--maxiter", "6",
                         "--divergence", "kl", "--out", out]))
    assert s["engine"] == "cnmf_encode" and s["k"] == k
    with np.load(out) as z:
        assert z["H"].shape == (B, k, n) and z["W"].shape == (m, k, T)


def test_cli_dict_rejected_for_other_solvers(tmp_path, run_cli):
    rng = np.random.default_rng(15)
    v = str(tmp_path / "V.npy")
    np.save(v, rng.uniform(0.1, 1, (8, 10)).astype(np.float32))
    w = str(tmp_path / "W.npy")
    np.save(w, rng.uniform(size=(8, 2)).astype(np.float32))
    refused(run_cli(["nmf", v, "--k", "2", "--dict", w, "--out", str(tmp_path / "o.npz")]),
            "--dict only applies")


def test_cli_encode_weights(tmp_path, run_cli):
    rng = np.random.default_rng(16)
    B, m, n, k = 2, 10, 12, 2
    vs = str(tmp_path / "Vs.npy")
    np.save(vs, rng.uniform(0.1, 1, (B, m, n)).astype(np.float32))
    w = str(tmp_path / "W.npy")
    np.save(w, rng.uniform(size=(m, k)).astype(np.float32))
    mw = str(tmp_path / "M.npy")
    np.save(mw, (rng.uniform(size=(m, n)) < 0.8).astype(np.float32))
    out = str(tmp_path / "enc.npz")
    summary(run_cli(["encode", vs, "--dict", w, "--weights", mw, "--maxiter", "6",
                     "--out", out]))
    with np.load(out) as z:
        assert z["H"].shape == (B, k, n)


def test_cli_encode_streaming(tmp_path, run_cli):
    rng = np.random.default_rng(17)
    m, n, k = 12, 50, 2
    v = str(tmp_path / "V.npy")
    np.save(v, rng.uniform(0.1, 1, (m, n)).astype(np.float32))
    w = str(tmp_path / "W.npy")
    np.save(w, rng.uniform(size=(m, k)).astype(np.float32))
    out = str(tmp_path / "enc.npz")
    s = summary(run_cli(["encode", v, "--dict", w, "--streaming", "--block-size", "16",
                         "--maxiter", "6", "--out", out]))
    assert s["streaming"] is True and s["k"] == k
    with np.load(out) as z:
        assert z["H"].shape == (k, n)


def test_cli_streaming_pick_rank_svd(tmp_path, run_cli):
    rng = np.random.default_rng(18)
    m, n, r = 24, 120, 3
    V = (rng.gamma(2.0, 1.0, (m, r)) @ rng.gamma(0.5, 1.0, (r, n))).astype(np.float32)
    v = str(tmp_path / "V.npy")
    np.save(v, V)
    out = str(tmp_path / "o.npz")
    s = summary(run_cli(["nmf", v, "--streaming", "--pick-rank", "svd", "--rank-energy",
                         "0.999", "--block-size", "40", "--maxiter", "3", "--out", out]))
    assert 2 <= s["k"] <= 4
    refused(run_cli(["nmf", v, "--streaming", "--pick-rank", "2,3,4", "--out", out]),
            "consensus")


def _make_mixture(tmp_path, sr=4000, dur=0.8):
    """Two synthetic sources + mixture as wav files."""
    from scipy.io import wavfile
    rng = np.random.default_rng(21)
    t = np.arange(int(sr * dur)) / sr
    a = 0.5 * np.sin(2 * np.pi * 330 * t) + 0.3 * np.sin(2 * np.pi * 495 * t)
    b = np.zeros_like(t)
    for i in range(0, len(t) - 200, 450):
        b[i: i + 200] += rng.normal(size=200) * np.exp(-np.arange(200) / 40.0)
    mix = a + b
    paths = {}
    for name, x in [("a", a), ("b", b), ("mix", mix)]:
        p = str(tmp_path / f"{name}.wav")
        wavfile.write(p, sr, (x / 2.0).astype(np.float32))
        paths[name] = p
    return paths, {"a": a, "b": b, "mix": mix, "sr": sr}


def test_cli_separate_solos_wav(tmp_path, run_cli):
    from scipy.io import wavfile
    paths, sig = _make_mixture(tmp_path)
    s = summary(run_cli(["separate", paths["mix"], "--solos", f"{paths['a']},{paths['b']}",
                         "--ks", "4", "--n-fft", "256", "--hop", "64", "--maxiter", "60",
                         "--out", str(tmp_path / "stem")]))
    assert s["sources"] == 2 and s["ranks"] == [4, 4]
    assert s["sample_rate"] == sig["sr"]
    rate0, y0 = wavfile.read(s["stems"][0])
    rate1, y1 = wavfile.read(s["stems"][1])
    assert rate0 == rate1 == sig["sr"]
    mix = sig["mix"] / 2.0
    np.testing.assert_allclose(y0 + y1, mix, atol=1e-4)
    for y, ref in [(y0, sig["a"] / 2.0), (y1, sig["b"] / 2.0)]:
        assert np.sum((y - ref) ** 2) < 0.5 * np.sum((mix - ref) ** 2)


def test_cli_separate_dicts_spectrogram(tmp_path, run_cli):
    rng = np.random.default_rng(22)
    m, n = 48, 90
    A = rng.gamma(2.0, 1.0, (m, 3)) @ rng.gamma(0.7, 1.0, (3, n))
    B = rng.gamma(2.0, 1.0, (m, 3)) @ rng.gamma(0.7, 1.0, (3, n))
    for name, S in [("A", A), ("B", B)]:
        np.save(tmp_path / f"{name}.npy", S.astype(np.float32))
        summary(run_cli(["nmf", str(tmp_path / f"{name}.npy"), "--k", "3",
                         "--maxiter", "80", "--out", str(tmp_path / f"d{name}.npz")]))
    mixp = str(tmp_path / "mix.npy")
    np.save(mixp, (A + B).astype(np.float32))
    s = summary(run_cli(["separate", mixp, "--dicts",
                         f"{tmp_path / 'dA.npz'},{tmp_path / 'dB.npz'}",
                         "--maxiter", "80", "--power", "1.0", "--out", str(tmp_path / "sep")]))
    est = [np.load(p) for p in s["stems"]]
    np.testing.assert_allclose(est[0] + est[1], A + B, rtol=1e-4, atol=1e-4)
    assert np.sum((est[0] - A) ** 2) < 0.3 * np.sum((A + B - A) ** 2)


def test_cli_separate_validation(tmp_path, run_cli):
    np.save(tmp_path / "V.npy", np.random.default_rng(0).uniform(
        0.1, 1, (20, 30)).astype(np.float32))
    v = str(tmp_path / "V.npy")
    np.save(tmp_path / "W.npy", np.random.default_rng(1).uniform(
        size=(20, 3)).astype(np.float32))
    w = str(tmp_path / "W.npy")
    out = str(tmp_path / "s")
    refused(run_cli(["separate", v, "--out", out]), "exactly one of")
    refused(run_cli(["separate", v, "--dicts", w, "--solos", v, "--out", out]),
            "exactly one of")
    refused(run_cli(["separate", v, "--dicts", w, "--k", "3", "--out", out]), "--k")
    refused(run_cli(["separate", v, "--solos", v, "--out", out]))
    np.save(tmp_path / "Wbad.npy", np.random.default_rng(2).uniform(
        size=(9, 3)).astype(np.float32))
    refused(run_cli(["separate", v, "--dicts", str(tmp_path / "Wbad.npy"), "--out", out]),
            "rows")
    refused(run_cli(["nmf", v, "--k", "3", "--ks", "4", "--out", out + ".npz"]), "separate")


def test_cli_encode_complex_phase_aware(tmp_path, run_cli):
    rng = np.random.default_rng(33)
    m, n, B = 16, 20, 3
    A1 = rng.gamma(2.0, 1.0, (m, 2)) @ rng.gamma(0.7, 1.0, (2, n))
    A2 = rng.gamma(2.0, 1.0, (m, 2)) @ rng.gamma(0.7, 1.0, (2, n))
    np.save(tmp_path / "mix.npy", (A1 + A2).astype(np.float32))
    summary(run_cli(["nmf", str(tmp_path / "mix.npy"), "--k", "4", "--maxiter", "40",
                     "--out", str(tmp_path / "d.npz")]))
    W = load_factors(str(tmp_path / "d.npz"))["W_init"]
    save_factors(str(tmp_path / "d2.npz"), {"W": [W[:, :2], W[:, 2:]]})
    Vs = rng.uniform(0.1, 1, (B, m, n)) * np.exp(1j * rng.uniform(-np.pi, np.pi, (B, m, n)))
    np.save(tmp_path / "batch.npy", Vs.astype(np.complex64))
    out = str(tmp_path / "enc.npz")
    s = summary(run_cli(["encode", str(tmp_path / "batch.npy"), "--dict",
                         str(tmp_path / "d2.npz"), "--maxiter", "12", "--out", out]))
    assert s["engine"] == "cmfwisa_encode" and s["k"] == 4
    with np.load(out) as z:
        assert z["H__len"] == 2 and z["H__0"].shape == (B, 2, n)
        assert z["P__0"].shape == (B, m, n) and np.iscomplexobj(z["P__0"])
    refused(run_cli(["encode", str(tmp_path / "batch.npy"), "--dict",
                     str(tmp_path / "d2.npz"), "--streaming", "--out", out]), "phase-aware")


def test_cli_separate_phase_aware(tmp_path, run_cli):
    from scipy.io import wavfile
    paths, sig = _make_mixture(tmp_path)
    out = str(tmp_path / "pa")
    s = summary(run_cli(["separate", paths["mix"], "--solos", f"{paths['a']},{paths['b']}",
                         "--ks", "4", "--n-fft", "256", "--hop", "64", "--maxiter", "50",
                         "--phase-aware", "--out", out]))
    assert s["phase_aware"] is True and s["sources"] == 2
    _, y0 = wavfile.read(s["stems"][0])
    _, y1 = wavfile.read(s["stems"][1])
    mix = sig["mix"] / 2.0
    np.testing.assert_allclose(y0 + y1, mix, atol=1e-4)
    for y, ref in [(y0, sig["a"] / 2.0), (y1, sig["b"] / 2.0)]:
        assert np.sum((y - ref) ** 2) < 0.6 * np.sum((mix - ref) ** 2)
    np.save(tmp_path / "mag.npy", np.abs(
        np.random.default_rng(0).normal(size=(20, 30))).astype(np.float32))
    np.save(tmp_path / "Wm.npy", np.random.default_rng(1).uniform(
        size=(20, 3)).astype(np.float32))
    refused(run_cli(["separate", str(tmp_path / "mag.npy"), "--dicts",
                     str(tmp_path / "Wm.npy"), "--phase-aware", "--out", out]),
            "phase information")
    refused(run_cli(["nmf", str(tmp_path / "mag.npy"), "--k", "3", "--phase-aware",
                     "--out", str(tmp_path / "x.npz")]), "separate")


def test_cli_separate_review_fixes(tmp_path, run_cli):
    from scipy.io import wavfile
    rng = np.random.default_rng(40)
    m, n = 24, 40
    A = rng.gamma(2.0, 1.0, (m, 2)) @ rng.gamma(0.7, 1.0, (2, n))
    B = rng.gamma(2.0, 1.0, (m, 2)) @ rng.gamma(0.7, 1.0, (2, n))
    np.save(tmp_path / "mix.npy", (A + B).astype(np.float32))
    np.save(tmp_path / "WA.npy", (rng.uniform(0.5, 1.0, (m, 2)) * 37.0).astype(np.float32))
    np.save(tmp_path / "WB.npy", (rng.uniform(0.5, 1.0, (m, 2)) * 0.02).astype(np.float32))
    out = str(tmp_path / "s")
    s = summary(run_cli(["separate", str(tmp_path / "mix.npy"), "--dicts",
                         f"{tmp_path / 'WA.npy'},{tmp_path / 'WB.npy'}",
                         "--maxiter", "30", "--out", out]))
    est = [np.load(p) for p in s["stems"]]
    np.testing.assert_allclose(est[0] + est[1], A + B, rtol=1e-4, atol=1e-4)
    assert 0.05 < np.sum(est[0]) / np.sum(A + B) < 0.95
    refused(run_cli(["separate", str(tmp_path / "mix.npy"), "--dicts",
                     f"{tmp_path / 'WA.npy'}", "--phase-aware", "--power", "1.0",
                     "--out", out]), "--power")
    refused(run_cli(["separate", str(tmp_path / "mix.npy"), "--dicts",
                     f"{tmp_path / 'WA.npy'}", "--phase-aware", "--divergence", "kl",
                     "--out", out]), "--divergence")
    t8 = np.arange(1600) / 8000.0
    wavfile.write(str(tmp_path / "mix8k.wav"), 8000,
                  np.sin(2 * np.pi * 300 * t8).astype(np.float32))
    wavfile.write(str(tmp_path / "solo44k.wav"), 44100,
                  np.sin(2 * np.pi * 300 * t8).astype(np.float32))
    refused(run_cli(["separate", str(tmp_path / "mix8k.wav"), "--solos",
                     str(tmp_path / "solo44k.wav"), "--ks", "2", "--n-fft", "256",
                     "--out", out]), "44100")
    u8 = (128 + 100 * np.sin(2 * np.pi * 300 * t8)).astype(np.uint8)
    wavfile.write(str(tmp_path / "u8.wav"), 8000, u8)
    x, rate = cli._read_signal(str(tmp_path / "u8.wav"))
    assert rate == 8000 and abs(float(np.mean(x))) < 0.02
    assert 0.7 < float(np.max(np.abs(x))) <= 1.0
    (tmp_path / "junk.bin").write_bytes(b"not-a-npy")
    refused(run_cli(["separate", str(tmp_path / "junk.bin"), "--dicts",
                     str(tmp_path / "WA.npy"), "--out", out]), "cannot read mixture")


def test_cli_nmf2d(tmp_path, run_cli):
    rng = np.random.default_rng(50)
    np.save(tmp_path / "V.npy", rng.uniform(0.1, 1, (20, 30)).astype(np.float32))
    out = str(tmp_path / "f.npz")
    s = summary(run_cli(["nmf2d", str(tmp_path / "V.npy"), "--k", "2", "--context-len",
                         "2", "--pitch-len", "3", "--maxiter", "8", "--out", out]))
    assert s["iterations"] == 8
    with np.load(out) as z:
        assert z["W"].shape == (20, 2, 2) and z["H"].shape == (2, 30, 3)
    refused(run_cli(["nmf2d", str(tmp_path / "V.npy"), "--k", "2", "--context-len", "2",
                     "--out", out]), "pitch-len")
    refused(run_cli(["nmf", str(tmp_path / "V.npy"), "--k", "2", "--pitch-len", "2",
                     "--out", out]), "nmf2d")


def test_cli_symnmf(tmp_path, run_cli):
    rng = np.random.default_rng(51)
    labels = np.repeat([0, 1], [10, 12])
    A = (labels[:, None] == labels[None, :]) * 0.8 + 0.1 + 0.05 * rng.uniform(size=(22, 22))
    np.save(tmp_path / "A.npy", ((A + A.T) / 2).astype(np.float32))
    out = str(tmp_path / "h.npz")
    summary(run_cli(["symnmf", str(tmp_path / "A.npy"), "--k", "2", "--maxiter", "100",
                     "--out", out]))
    with np.load(out) as z:
        H = z["H"]
    assert H.shape == (22, 2)
    pred = np.argmax(H, axis=1)
    assert max(np.mean(pred == labels), np.mean(pred == 1 - labels)) == 1.0


def test_cli_symnmf_rejects_inapplicable_flags(tmp_path, run_cli):
    np.save(tmp_path / "A.npy", np.eye(8, dtype=np.float32))
    out = str(tmp_path / "h.npz")
    refused(run_cli(["symnmf", str(tmp_path / "A.npy"), "--k", "2", "--divergence", "kl",
                     "--out", out]), "--divergence")
    refused(run_cli(["symnmf", str(tmp_path / "A.npy"), "--k", "2", "--h-sparsity", "0.5",
                     "--out", out]), "h-sparsity")


def test_cli_encode_nmf2d(tmp_path, run_cli):
    """encode --pitch-len routes a 3-D dictionary to nmf2d_encode; it
    refuses --cost-every there, as the JAX CLI does (cli.py:579)."""
    rng = np.random.default_rng(70)
    B, m, n, k, T, P = 2, 12, 16, 2, 2, 3
    W = rng.uniform(0.1, 1, (m, k, T)).astype(np.float32)
    np.save(tmp_path / "W.npy", W)
    np.save(tmp_path / "batch.npy", rng.uniform(0.1, 1, (B, m, n)).astype(np.float32))
    out = str(tmp_path / "enc.npz")
    s = summary(run_cli(["encode", str(tmp_path / "batch.npy"), "--dict",
                         str(tmp_path / "W.npy"), "--pitch-len", str(P), "--maxiter", "6",
                         "--out", out]))
    assert s["engine"] == "nmf2d_encode"
    with np.load(out) as z:
        assert z["H"].shape == (B, k, n, P)
    np.save(tmp_path / "W2.npy", W[:, :, 0])
    refused(run_cli(["encode", str(tmp_path / "batch.npy"), "--dict",
                     str(tmp_path / "W2.npy"), "--pitch-len", "2", "--out", out]), "3-D")
    refused(run_cli(["encode", str(tmp_path / "batch.npy"), "--dict",
                     str(tmp_path / "W.npy"), "--pitch-len", str(P), "--cost-every", "2",
                     "--out", out]), "--cost-every", "nmf2d_encode")


def test_cli_device_flag(matrix_file, tmp_path, run_cli):
    """--device defaults to the card: without one the CLI says so
    cleanly; an unknown device is refused too."""
    out = str(tmp_path / "f.npz")
    if not torch.cuda.is_available():
        refused(run_cli(["nmf", matrix_file, "--k", "2", "--out", out], device=False),
                "no CUDA card", "--device cpu")
    refused(run_cli(["nmf", matrix_file, "--k", "2", "--out", out, "--device", "nodevice"],
                    device=False), "--device")
    assert not os.path.exists(out)
    assert cli.build_parser().parse_args(["nmf", "x", "--out", "y"]).device == "cuda"
