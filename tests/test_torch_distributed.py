"""The port across real OS processes: the ``nmf`` half of
tests/test_distributed_multiproc.py.  Two Gloo ranks (tests/torch_mesh.py)
solve a problem whose n (and, on the (2, 1) mesh, m) the mesh does not
divide; the ranks' trajectories must be bit-identical to each other and
match the JAX package on ``make_mesh(2)`` and the port with no mesh, in
f64 at 1e-10.  Then the command line under ``torchrun --standalone``
(``init_distributed`` from torchrun's environment): ``nmf --mesh 2``
writes one --out, the same factors as the single-process run.  The
command destroys the process group it joined, and leaves one its caller
made.
"""
import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import nmf_toolbox_tpu as jt  # noqa: E402
import nmf_toolbox_tpu_torch as tt  # noqa: E402
from nmf_toolbox_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402

import torch_mesh  # noqa: E402
from torch_mesh import Ranks  # noqa: E402

REPO = str(pathlib.Path(__file__).resolve().parents[1])
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402
CPU = {"device": "cpu"}


@pytest.fixture(scope="module")
def ranks():
    r = Ranks(2)
    yield r
    r.close()


@pytest.mark.parametrize("kind", ["1d", "2d"])
@pytest.mark.parametrize("div,method", [("euclidean", "gram"), ("kl", "naive")])
def test_two_process_mesh_parity(ranks, kind, div, method):
    rng = np.random.default_rng(0)
    V = rng.uniform(0.1, 1.0, (33, 67))
    kw = dict(W_init=rng.uniform(size=(33, 4)), H_init=rng.uniform(size=(4, 67)),
              divergence=div, method=method, maxiter=15, tolerance=1e-12,
              dtype=np.float64)
    got = ranks.solve("nmf_toolbox_tpu_torch.nmf", V, 4, mesh=kind, **kw)
    jm = jmake_mesh(2) if kind == "1d" else jmake_mesh(shape=(2, 1))
    for want in (jt.nmf(V, 4, mesh=jm, **kw), tt.nmf(V, 4, **kw, **CPU)):
        w = {f: getattr(want, f) for f in ("W", "H")}
        for f, x in w.items():
            x = x.numpy() if torch.is_tensor(x) else np.asarray(x)
            np.testing.assert_allclose(got[f], x, atol=1e-10, err_msg=f)
        np.testing.assert_allclose(got["cost"], np.asarray(want.cost), rtol=1e-10)
        assert got["n_iters"] == want.n_iters


def test_cli_under_torchrun(tmp_path):
    rng = np.random.default_rng(1)
    V = rng.uniform(0.1, 1.0, (30, 41))
    np.save(tmp_path / "V.npy", V)
    from nmf_toolbox_tpu_torch.utils.checkpoint import save_factors
    save_factors(tmp_path / "init.npz", {"W": rng.uniform(size=(30, 3)),
                                         "H": rng.uniform(size=(3, 41))})
    args = ["nmf", str(tmp_path / "V.npy"), "--k", "3", "--maxiter", "6",
            "--dtype", "float64", "--tolerance", "1e-12", "--device", "cpu",
            "--resume", str(tmp_path / "init.npz")]
    env = {"PYTHONPATH": REPO, "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "HOME": str(tmp_path), "OMP_NUM_THREADS": "1", "PYTHONFAULTHANDLER": "1"}
    r = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                        "--nproc-per-node", "2", "-m", "nmf_toolbox_tpu_torch"]
                       + args + ["--mesh", "2", "--out", str(tmp_path / "m.npz")],
                       capture_output=True, text=True, cwd=REPO, env=env, timeout=240)
    assert r.returncode == 0, r.stderr[-1500:]
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1  # rank 0 alone prints
    assert json.loads(lines[0])["iterations"] == 6
    from nmf_toolbox_tpu_torch import cli
    assert cli.main(args + ["--out", str(tmp_path / "s.npz"), "--quiet"]) == 0
    with np.load(tmp_path / "m.npz") as a, np.load(tmp_path / "s.npz") as b:
        np.testing.assert_allclose(a["W"], b["W"], atol=1e-10)
        np.testing.assert_allclose(a["H"], b["H"], atol=1e-10)


def _cli_args(tmp_path):
    rng = np.random.default_rng(2)
    np.save(tmp_path / "V.npy", rng.uniform(0.1, 1.0, (12, 16)))
    return ["nmf", str(tmp_path / "V.npy"), "--k", "2", "--maxiter", "3", "--device",
            "cpu", "--mesh", "2", "--quiet"]


def test_cli_destroys_the_group_it_made(tmp_path):
    """Two ranks with torchrun's environment and no group: the command
    joins one, runs, and leaves none behind."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    (tmp_path / "port").write_text(str(port))
    (tmp_path / "argv.json").write_text(json.dumps(_cli_args(tmp_path)))
    got = chip_smoke.spawn_ranks(torch_mesh.cli_own_group, str(tmp_path), n=2, timeout=120)
    assert got == {r: {"rc": 0, "initialized_after": False} for r in (0, 1)}


def test_cli_keeps_the_callers_group(ranks, tmp_path):
    argv = _cli_args(tmp_path) + ["--out", str(tmp_path / "kept.npz")]
    assert ranks.run(torch_mesh.cli_kept_group, argv) == [(0, True), (0, True)]
