"""What the four-card mesh (chip_smoke.py phase 19) relies on, on the CPU:
each rank's choice of card, the index-less "cuda" resolved before a
device comparison, chip_smoke's N-rank spawn helper with four Gloo ranks
(every rank reaped, a failed rank reported), and four processes that
build the kernel library at once (one build, no half-written file)."""
import multiprocessing
import os
import pathlib
import stat
import sys
import types

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
import torch_mesh  # noqa: E402
from nmf_toolbox_tpu_torch import core  # noqa: E402
from nmf_toolbox_tpu_torch.parallel import mesh as pmesh  # noqa: E402


@pytest.fixture
def four_cards(monkeypatch):
    """A host with four cards, as far as the rank-to-card choice can
    tell; the cards set current are recorded."""
    chosen = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", chosen.append)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: chosen[-1] if chosen else 0)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    return chosen


@pytest.mark.parametrize("local_rank,rank,card", [(None, 5, 1), ("1", 5, 1), ("6", 0, 2),
                                                  ("3", 3, 3), (None, 0, 0)])
def test_init_distributed_takes_the_local_ranks_card(four_cards, monkeypatch,
                                                     local_rank, rank, card):
    joined = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda *a, **kw: joined.append((a, kw)))
    if local_rank is not None:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    pmesh.init_distributed("file:///nowhere", 8, rank, backend="nccl")
    assert four_cards == [card]
    assert joined[0][0] == ("nccl",) and joined[0][1]["rank"] == rank
    assert joined[0][1]["world_size"] == 8


def test_gloo_leaves_the_card_alone(four_cards, monkeypatch):
    monkeypatch.setattr(torch.distributed, "init_process_group", lambda *a, **kw: None)
    pmesh.init_distributed("file:///nowhere", 4, 2, backend="gloo")
    assert four_cards == []


@pytest.mark.parametrize("rank", range(4))
def test_a_cuda_meshs_device_is_the_ranks_card(four_cards, monkeypatch, rank):
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: rank)
    fake = types.SimpleNamespace(mesh_dim_names=("n",), mesh=torch.arange(4),
                                 device_type="cuda")
    assert pmesh.Mesh(fake).device == torch.device("cuda", rank)


def test_cuda_resolves_to_the_current_card(four_cards):
    four_cards.append(2)
    assert core.concrete_device("cuda") == torch.device("cuda", 2)
    assert core.concrete_device("cuda:1") == torch.device("cuda", 1)
    assert core.concrete_device("cpu") == torch.device("cpu")
    assert core.resolve_device(None, "cuda") == torch.device("cuda", 2)
    mesh = types.SimpleNamespace(device=torch.device("cuda", 2))
    assert core.resolve_device(None, "cuda", mesh) == mesh.device
    assert core.resolve_device(None, None, mesh) == mesh.device
    with pytest.raises(ValueError, match="mesh's device"):
        core.resolve_device(None, "cuda:1", mesh)
    with pytest.raises(ValueError, match="mesh's device"):
        core.resolve_device(None, "cpu", mesh)


def _gone(pid):
    return not pathlib.Path(f"/proc/{pid}").exists()


def test_spawn_ranks_runs_four_gloo_ranks_and_reaps_them(tmp_path):
    got = chip_smoke.spawn_ranks(torch_mesh.gloo_sum, str(tmp_path), n=4, timeout=120)
    assert sorted(got) == [0, 1, 2, 3]
    for r, g in got.items():
        assert g["sum"] == 6.0 and g["local_rank"] == str(r)
        assert _gone(g["pid"])
    assert len({g["pid"] for g in got.values()}) == 4
    assert multiprocessing.active_children() == []


def test_spawn_ranks_reports_a_failed_rank(tmp_path):
    got = chip_smoke.spawn_ranks(torch_mesh.fail_on_two, str(tmp_path), n=4, timeout=120)
    assert got[2] == {"error": "rank 2 failed"}
    assert all(_gone(got[r]["pid"]) for r in (0, 1, 3))
    assert multiprocessing.active_children() == []


FAKE_NVCC = """#!{python}
import os, pathlib, sys, time
args = sys.argv[1:]
with open({calls!r}, "a") as f:
    f.write(("link" if "-shared" in args else "compile") + "\\n")
time.sleep(0.5)
out = pathlib.Path(args[args.index("-o") + 1])
if "-shared" in args:
    objs = [a for a in args if a.endswith(".o")]
    out.write_bytes(b"".join(pathlib.Path(o).read_bytes() for o in objs))
else:
    out.write_bytes(pathlib.Path(args[-1]).name.encode() + b";")
print("ptxas info: fake")
"""


def test_ranks_that_build_at_once_build_once(tmp_path):
    """Four processes call ``_build.build`` together: one compiles (one
    nvcc a source, one link), the others wait on the lock and load its
    library; the log is whole and no temporary file is left."""
    from nmf_toolbox_tpu_torch.ops.kernels import _build
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    calls = tmp_path / "calls.log"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, calls=str(calls)))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    got = chip_smoke.spawn_ranks(torch_mesh.build_library, str(tmp_path), n=4, timeout=120)
    assert all("error" not in g for g in got.values()), got
    assert calls.read_text().split() == ["compile"] * len(_build.sources()) + ["link"]
    want = b"".join(f"{p.name};".encode() for p in _build.sources())
    assert {g["bytes"] for g in got.values()} == {want}
    lib = pathlib.Path(got[0]["path"])
    assert {g["path"] for g in got.values()} == {str(lib)}
    left = sorted(p.name for p in lib.parent.iterdir())
    assert left == sorted([lib.name, lib.with_suffix(".log").name, lib.with_suffix(".lock").name])
    log = lib.with_suffix(".log").read_text()
    assert log.count("ptxas info: fake") == len(_build.sources()) + 1  # and the link
    assert os.access(lib, os.R_OK)
