"""CPU tests of the solver contract (``nmfbench/solvers/``): a second solver
of the port runs through the harness as new files alone, a traffic file's
``options`` reach the entry point, and the ``nmf`` solver, moved out of the
harness, reads as the harness read before
(run: python -m pytest nmfbench/tests -q)."""
from __future__ import annotations

import ast
import importlib
import json
import shutil

import numpy as np
import pytest
import torch

import nmf_toolbox_tpu_torch as nt
from nmfbench import cells, check, control, data, harness, work
from nmfbench.reference import mu
from nmfbench.tests import support
from nmfbench.tests.test_nmfbench_harness import _altered_answer, _unchanged_state

SEED = 2 ** 31 + 777  # larger than 32 signed bits hold
HALS_FILES = support.HERE / "tests" / "hals_solver"
HALS_CONFIG = {"name": "tinyhals", "solver": "nmf_hals", "m": 64, "n": 40, "k": 8,
               "dtype": "float32", "reference": "nmfbench/reference/hals.py"}


def hals_root(tmp_path, **traffic):
    """A root whose BENCHMARK.json has one cell of the port's ``nmf_hals``,
    added as a later change would add it: a config, a traffic file, a
    solver module and a plain reference, and entries naming them."""
    root = support.make_root(tmp_path, cells=("tinyeuc.gram",))
    bench_dir = root / "nmfbench"
    shutil.copy(HALS_FILES / "nmf_hals.py", bench_dir / "solvers" / "nmf_hals.py")
    shutil.copy(HALS_FILES / "hals.py", bench_dir / "reference" / "hals.py")
    (bench_dir / "configs" / "tinyhals.json").write_text(json.dumps(HALS_CONFIG))
    t = support.traffic("tinyeuc.gram", config="tinyhals", **traffic)
    (bench_dir / "traffic" / "tinyhals.sweeps.json").write_text(json.dumps(t))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tinyhals", "source": "test",
                             "file": "nmfbench/configs/tinyhals.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "tinyhals.sweeps", "config": "tinyhals",
                               "traffic": "tinyhals.sweeps", "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run(capsys, root, cell, seconds=0.3, trace=0):
    """(the result line, the numbers and solves that the run printed)."""
    rc = harness.main(["--workload", cell, "--seed", str(SEED), "--seconds", str(seconds),
                       "--trace", str(trace), "--cpu-test"], root=root)
    captured = capsys.readouterr()
    assert rc == 0, captured.err[-2000:]
    printed = [json.loads(x) for x in captured.err.splitlines() if x.startswith('{"solves"')]
    return json.loads(captured.out.strip().splitlines()[-1]), printed[-1]


def _unchanged_hals_state(monkeypatch):
    """The step returns its state as it came (the sweeps update it in
    place, so the state is copied first)."""
    hals = importlib.import_module("nmf_toolbox_tpu_torch.models.hals")
    make = hals._plain_step

    def broken(*a, **k):
        step = make(*a, **k)

        def unchanged(carry, i):
            kept = tuple(t.clone() for t in carry)
            return (kept,) + tuple(step(carry, i)[1:])
        return unchanged
    monkeypatch.setattr(hals, "_plain_step", broken)


@pytest.mark.parametrize("fault", [None, _unchanged_hals_state])
def test_a_second_solver_runs_through_the_unedited_harness(tmp_path, capsys, monkeypatch,
                                                          fault):
    root = hals_root(tmp_path)
    if fault:
        fault(monkeypatch)
    for trace in (0, 1):
        line, printed = run(capsys, root, "tinyhals.sweeps", trace=trace)
        assert line["correct"] is (fault is None), line["checks"]
        assert line["attempted"] >= 1 and set(line["checks"]) == set(check.NUMBERS)
        want = {"iters_per_s", "tol_s", "setup_s"} if not trace else \
            {"tol_iters", "host_reads_per_iter"}
        assert set(line["metrics"]) == want


def test_traffic_options_reach_the_entry_point(tmp_path, capsys, monkeypatch):
    """``options`` go to ``nmf_hals`` as they stand; its reference sweeps as
    often, so the run is correct only where they arrived."""
    root = hals_root(tmp_path, options={"inner_iters": 2})
    seen, real = [], nt.nmf_hals

    def recording(*a, **k):
        seen.append(k)
        return real(*a, **k)
    monkeypatch.setattr(nt, "nmf_hals", recording)
    line, _ = run(capsys, root, "tinyhals.sweeps")
    assert seen and all(k["inner_iters"] == 2 for k in seen)
    assert line["correct"] is True, line["checks"]


def _numbers_as_before(cell, n_solves):
    """The drawn solve's index, ``n_iters`` and check numbers of a tiny
    one-card cell, worked out as the harness did before its solver moved
    into ``solvers/nmf.py``: ``nt.nmf`` and ``reference/mu.py`` called
    directly, the planted cost and the inits written out."""
    tr = support.traffic(cell)
    cfg = support.TINY_CONFIGS[tr["config"]]
    cpu = torch.device("cpu")
    V, (A, B, const) = data.make_v(cfg, tr, SEED, cpu)
    M = data.make_mask(cfg, tr, SEED, cpu)
    S = (A @ B).double() + const
    Vd = V.double()
    term = (0.5 * (Vd - S) ** 2 if cfg["divergence"] == "euclidean"
            else Vd * torch.log(Vd / S) - Vd + S)
    if M is not None:
        term = term * M.double()
    tol = tr["rel_tol"] * float(torch.sum(term))
    j = data.substream(SEED, "check") % n_solves
    g = data.generator(cpu, SEED, "init", j)
    W0 = torch.rand((cfg["m"], cfg["k"]), generator=g).clamp_min_(1e-30)
    H0 = torch.rand((cfg["k"], cfg["n"]), generator=g).clamp_min_(1e-30)
    kw = {"divergence": cfg["divergence"], "W_init": W0, "H_init": H0, "tolerance": tol,
          "maxiter": tr["cap"]}
    if tr["method"]:
        kw["method"] = tr["method"]
    if M is not None:
        kw["weights"] = M
    res = nt.nmf(V, cfg["k"], **kw)
    ref = mu.solve(V, W0, H0, cfg["divergence"], tol, tr["cap"], M=M,
                   snapshots=(res.n_iters,))
    nums = check.trajectory_gaps(torch, res.cost, res.n_iters, res.W, res.H, ref)
    nums["ref_n_iters"] = ref["n_iters"]
    return j, int(res.n_iters), nums


@pytest.mark.parametrize("cell", ["tinykl.fused", "tinyeuc.gram", "tinykl.masked",
                                  "tinykl.default"])
def test_moved_nmf_solver_reads_as_before(tmp_path, capsys, cell):
    root = support.make_root(tmp_path, cells=(cell,))
    line, printed = run(capsys, root, cell, seconds=0.001)
    j, n_iters, want = _numbers_as_before(cell, len(printed["solves"]))
    got = printed["numbers"]
    assert got["stop_breaks"] == 0 and line["correct"] is True
    assert printed["solves"][j][0] == n_iters
    assert {k: got[k] for k in want} == want
    bench = json.loads((root / "BENCHMARK.json").read_text())
    assert set(line["metrics"]) == {m["name"] for m in bench["end_to_end"]}


ENTRY_POINTS = {name for name in nt.__all__ if callable(getattr(nt, name, None))}
DIVERGENCES = {"kl", "euclidean", "is", "ab", "divergence"}
OWN = {"solvers/nmf.py", "reference/mu.py"}


def test_outside_the_nmf_solver_no_solver_is_called_and_no_divergence_named():
    """The harness knows solvers only through ``solvers/<solver>.py``:
    outside the ``nmf`` solver and its reference, no module of nmfbench/
    (tests aside) calls an entry point of the port, names a divergence or
    imports the reference."""
    bench = support.HERE
    for path in bench.rglob("*.py"):
        rel = path.relative_to(bench).as_posix()
        if rel in OWN or rel.startswith("tests/"):
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call):
                f = node.func
                name = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", None)
                assert name not in ENTRY_POINTS, (rel, name)
            elif isinstance(node, ast.Constant) and isinstance(node.value, str):
                assert node.value.lower() not in DIVERGENCES, (rel, node.value)
            elif isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in node.names] + [getattr(node, "module", None) or ""]
                assert not any(n == "mu" or n.endswith("reference.mu") for n in names), rel


def test_work_counts_through_the_solver():
    cfg = dict(HALS_CONFIG, m=3, n=5, k=2)
    solver = cells._module(HALS_FILES / "nmf_hals.py", "test_", "solver")
    assert work.flops_per_iter(cfg, {}, solver) == 4 * 30 + 4 * 4 * 8
    assert work.flops_per_iter(cfg, {"options": {"inner_iters": 2}}, solver) == \
        4 * 30 + 2 * 4 * 4 * 8
    assert work.least_seconds_per_iter(cfg, {}, "NVIDIA H100 80GB HBM3", 1, solver) == \
        pytest.approx(4 * (2 * 31 + 16) / 3.35e12)
    assert np.isfinite(work.bytes_per_iter(cfg, {}, solver))


# --- the default KL call (kl40k.default's path): faults and the control ------

def _half_the_batch_in_the_field(monkeypatch):
    """The naive step's field over half of V's columns, doubled: the rest
    of the batch left out, the mean taken over the half."""
    dv = importlib.import_module("nmf_toolbox_tpu_torch.ops.divergence")
    real = dv.fields

    def half(*a, **k):
        phi, pos, power = real(*a, **k)
        h = phi.shape[1] // 2
        phi = torch.cat([2.0 * phi[:, :h], torch.zeros_like(phi[:, h:])], dim=1)
        return phi, pos, power
    monkeypatch.setattr(dv, "fields", half)


@pytest.mark.parametrize("fault", [_unchanged_state, _half_the_batch_in_the_field,
                                   _altered_answer])
def test_a_broken_default_kl_path_is_not_correct(tmp_path, capsys, monkeypatch, fault):
    root = support.make_root(tmp_path, cells=("tinykl.default",))
    fault(monkeypatch)
    line, _ = run(capsys, root, "tinykl.default")
    assert line["correct"] is False


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def test_control_in_tf32_fails_the_default_cell(card):
    """kl40k.default's limits at a test size on the card: the program (the
    naive KL step with its CUDA cost pass) meets them on three seeds, the
    reference in TF32 in its place fails one of them on each."""
    cell = cells.load("kl40k.default")
    cell.config = dict(cell.config, m=4000, n=2000)
    limits = cell.traffic["limits"]
    for seed in (5, 6, 7):
        row = control.readings(cell, seed, card)
        assert check.judge(row["program"], limits)[0] is True, row
        assert check.judge(row["control"], limits)[0] is False, row
