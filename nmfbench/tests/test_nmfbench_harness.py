"""CPU tests of the benchmark under nmfbench/ (run: python -m pytest nmfbench/tests -q).

Tests marked ``cuda`` need a card and skip without one; they decide so in
a fixture."""
from __future__ import annotations

import ast
import importlib
import json
import os
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import nmf_toolbox_tpu_torch as nt
from nmfbench import cells, check, data, harness, timing, work
from nmfbench.reference import mu
from nmfbench.tests import support

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
BANNED = {"jax", "jaxlib", "flax", "nmf_toolbox_tpu"}
BENCH = support.HERE
SEED = 2 ** 31 + 12345  # larger than 32 signed bits hold


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def run_line(capsys, root, cell, trace=0, seconds=0.3, seed=SEED):
    rc = harness.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", str(trace), "--cpu-test"], root=root)
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


# --- BENCHMARK.json and the files it names ---------------------------------

def test_benchmark_json_follows_the_contract():
    root = support.REPO
    bench = json.loads((root / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["nmfbench"] and bench["command"][1] == "nmfbench/run.py"
    assert 1 <= bench["run_seconds"] <= 51
    cfg_names = [c["name"] for c in bench["configs"]]
    cell_names = [w["name"] for w in bench["workloads"]]
    metric_names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    for names in (cfg_names, cell_names, metric_names):
        assert len(set(names)) == len(names)
        assert all(NAME.match(n) for n in names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(c["source"]) and LINE.match(c["why"]) and c["reduced"] == []
        assert (root / c["file"]).is_file() and c["file"].startswith("nmfbench/")
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in cfg_names and w["chips"] in (1, 4) and LINE.match(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= 1
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        mod = cells.reader(BENCH, m["name"])
        assert mod.UNIT == m["unit"]
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and LINE.match(m["layer"])
        for cell in m.get("workloads", cell_names):
            assert cell in cell_names
            assert cell in e2e[m["moves"]].get("workloads", cell_names)
    for cell in cell_names:  # every cell reports setup_s, another end-to-end and a per-layer metric
        assert sum(cell in m.get("workloads", cell_names) for m in bench["end_to_end"]) >= 2
        assert any(cell in m.get("workloads", cell_names) for m in bench["per_layer"])
        loaded = cells.load(cell)
        assert loaded.chips in (1, 4)
    assert len((root / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for f in BENCH.rglob("*"):
        if f.is_file() and "__pycache__" not in f.parts and "_cache" not in f.parts:
            assert re.match(r"^[A-Za-z0-9_.\-/]+$", str(f.relative_to(root)))


def test_loader_finds_added_config_traffic_and_metric(tmp_path):
    """A later change adds a cell, a traffic mix and a metric by new files
    and new entries alone."""
    spec = {"name": "probe_count", "unit": "n", "better": "lower", "source": "program_counter",
            "layer": "convergence loop", "moves": "tol_s"}
    root = support.make_root(tmp_path, cells=("tinykl.fused", "tinyeuc.gram"), extra_metric=spec)
    (root / "nmfbench" / "metrics" / "probe_count.py").write_text(
        'UNIT = "n"\n\n\ndef read(run):\n    return len(run.solves)\n')
    cell = cells.load("tinyeuc.gram", root)
    assert cell.config["m"] == support.TINY_CONFIGS["tinyeuc"]["m"]
    assert cell.traffic["config"] == "tinyeuc"
    assert [s["name"] for s, _ in cell.per_layer][-1] == "probe_count"
    assert [s["name"] for s, _ in cell.end_to_end] == ["iters_per_s", "tol_s", "setup_s"]


def test_loader_refuses_a_unit_its_reader_does_not_give(tmp_path):
    spec = {"name": "probe_count", "unit": "s", "better": "lower", "source": "program_counter",
            "layer": "convergence loop", "moves": "tol_s"}
    root = support.make_root(tmp_path, extra_metric=spec)
    (root / "nmfbench" / "metrics" / "probe_count.py").write_text(
        'UNIT = "n"\n\n\ndef read(run):\n    return 1.0\n')
    with pytest.raises(ValueError, match="unit"):
        cells.load("tinykl.fused", root)


# --- the yardstick ----------------------------------------------------------

def test_work_counts_at_a_hand_checked_shape():
    cfg = {"m": 3, "n": 5, "k": 2, "divergence": "kl"}
    assert work.flops_per_iter(cfg, {}) == 8 * 30
    assert work.flops_per_iter(cfg, {"mask_zero_share": 0.2}) == 12 * 30
    # reads: 2 x (V 15 + W 6 + H 10) floats, writes W 6 + H 10
    assert work.bytes_per_iter(cfg, {}) == 4 * (2 * 31 + 16)
    assert work.bytes_per_iter(cfg, {"mask_zero_share": 0.2}) == 4 * (2 * 46 + 16)
    euc = dict(cfg, divergence="euclidean")
    assert work.flops_per_iter(euc, {}) == 4 * 30 + 4 * 4 * 8
    # at the card's peaks: 248 FLOP / 495e12 against 312 bytes / 3.35e12
    least = work.least_seconds_per_iter(euc, {}, "NVIDIA H100 80GB HBM3", 1)
    assert least == pytest.approx(4 * 78 / 3.35e12)
    assert work.least_seconds_per_iter(euc, {}, "NVIDIA H100 80GB HBM3", 4) == \
        pytest.approx(least / 4)
    assert work.least_seconds_per_iter(euc, {}, "cpu", 1) is None
    big = {"m": 40_000, "n": 10_000, "k": 100, "divergence": "kl"}
    assert work.flops_per_iter(big, {}) == pytest.approx(3.2e11)


@pytest.mark.parametrize("divergence,masked", [("kl", False), ("kl", True), ("euclidean", False)])
def test_reference_follows_the_port_in_f64(divergence, masked):
    cfg = {"m": 50, "n": 40, "k": 5, "divergence": divergence}
    tr = support.traffic("tinykl.masked" if masked else "tinykl.fused")
    cpu = torch.device("cpu")
    V, parts = data.make_v(cfg, tr, 7, cpu)
    M = data.make_mask(cfg, tr, 7, cpu) if masked else None
    tol = data.tolerance(cfg, tr, V, parts, M)
    W0, H0 = data.make_init(cfg, 7, 0, cpu)
    V, W0, H0 = V.double(), W0.double(), H0.double()
    M = None if M is None else M.double()
    kw = {"weights": M} if masked else {}
    res = nt.nmf(V, 5, divergence=divergence, W_init=W0, H_init=H0, tolerance=tol,
                 maxiter=500, device="cpu", dtype="float64", **kw)
    ref = mu.solve(V, W0, H0, divergence, tol, 500, M=M, snapshots=(res.n_iters,))
    assert res.converged and ref["n_iters"] == res.n_iters
    gaps = check.trajectory_gaps(torch, res.cost, res.n_iters, res.W, res.H, ref)
    assert gaps["cost_gap"] < 1e-11 and gaps["W_gap"] < 1e-9 and gaps["H_gap"] < 1e-9


def test_inputs_repeat_from_the_seed():
    cfg = support.TINY_CONFIGS["tinykl"]
    tr = support.traffic("tinykl.masked")
    cpu = torch.device("cpu")
    a, b = data.make_v(cfg, tr, SEED, cpu)[0], data.make_v(cfg, tr, SEED, cpu)[0]
    assert torch.equal(a, b) and not torch.equal(a, data.make_v(cfg, tr, SEED + 1, cpu)[0])
    assert float(a.min()) >= tr["assumed"]["generator"]["floor"]
    assert torch.equal(data.make_init(cfg, SEED, 3, cpu)[0], data.make_init(cfg, SEED, 3, cpu)[0])
    M = data.make_mask(cfg, tr, SEED, cpu)
    assert set(M.unique().tolist()) == {0.0, 1.0}


def test_stop_breaks_reads_the_rule_in_f32():
    tol = 0.5
    assert check.stop_breaks([10.0, 5.0, 4.8], 3, True, tol) == 0
    assert check.stop_breaks([10.0, 5.0, 4.8, 4.7], 4, True, tol) == 1  # fired at 3 already
    assert check.stop_breaks([10.0, 5.0], 2, True, tol) == 1  # did not fire at 2
    assert check.stop_breaks([10.0, 5.0, 3.0], 3, False, tol) == 0
    assert check.stop_breaks([10.0, 5.0, 3.0], 4, False, tol) == 1  # n_iters disagrees


def test_trace_reading_unions_busy_time_and_names_gaps():
    ev = [
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 0, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "b", "ts": 5, "dur": 10},   # overlaps a
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 40, "dur": 10},
        {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 60, "dur": 5},
        {"ph": "X", "cat": "cpu_op", "name": "outer", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 16, "dur": 20},
    ]
    r = timing.read_trace(ev)
    assert r["busy_s"] == pytest.approx(30e-6)
    assert dict(r["device_ops"]) == pytest.approx({"a": 20e-6, "b": 10e-6, "copy": 5e-6})
    assert dict(r["idle_gaps"]) == pytest.approx({"aten::item": 25e-6, "outer": 10e-6})


# --- a whole run on the CPU ----------------------------------------------------

def test_result_line_keys_names_and_units(tmp_path, capsys):
    root = support.make_root(tmp_path, cells=("tinykl.fused",))
    for trace in (0, 1):
        line = run_line(capsys, root, "tinykl.fused", trace=trace)
        assert list(line)[-1] == "checks"
        assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
        assert line["correct"] is True and line["attempted"] >= 1 and line["failed"] == 0
        dev = line["device"]
        assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
        for name, m in line["metrics"].items():
            assert NAME.match(name) and UNIT.match(m["unit"]) and np.isfinite(m["value"])
        bench = json.loads((root / "BENCHMARK.json").read_text())
        want = {m["name"] for m in bench["per_layer" if trace else "end_to_end"]}
        if trace:
            assert {"busy_s", "window_s"} <= set(dev) and set(line["breakdown"]) == \
                {"device_ops", "idle_gaps"}
            # no card, no device trace: those readers find nothing and stay out
            want -= {"kernels_roofline", "idle_pct", "mfu_pct", "collectives_per_iter"}
        assert set(line["metrics"]) == want
        assert set(line["checks"]) == set(check.NUMBERS)


@pytest.mark.parametrize("cell", ["kl40k.fused", "euc100k.mesh4"])
def test_no_card_no_result(capsys, monkeypatch, cell):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("PYTHONPATH", str(support.REPO))
    rc = harness.main(["--workload", cell, "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_only_the_benchmark_files_no_result(tmp_path):
    """A checkout of BENCHMARK.json and nmfbench/ alone: no program, no line."""
    import subprocess
    root = support.make_root(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "nmfbench/run.py", "--workload", "tinykl.fused",
                          "--seed", "1", "--seconds", "0.2", "--trace", "0", "--cpu-test"],
                         cwd=root, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    assert "nmf_toolbox_tpu_torch" in out.stderr


def test_a_loaded_jax_module_stops_the_line(tmp_path, capsys, monkeypatch):
    root = support.make_root(tmp_path)
    monkeypatch.setitem(sys.modules, "jaxlib", type(sys)("jaxlib"))
    rc = harness.main(["--workload", "tinykl.fused", "--seed", "3", "--seconds", "0.2",
                       "--trace", "0", "--cpu-test"], root=root)
    captured = capsys.readouterr()
    assert rc != 0 and captured.out == "" and "jaxlib" in captured.err


def test_no_module_imports_jax_or_the_jax_package():
    """Top-level names compared whole: nmf_toolbox_tpu_torch is not
    nmf_toolbox_tpu.  The reference imports nothing of the program."""
    for path in BENCH.rglob("*.py"):
        tree = ast.parse(path.read_text())
        names = []
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names += [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names.append(node.module)
        tops = {n.split(".")[0] for n in names}
        assert not tops & BANNED, (path, tops & BANNED)
        if "reference" in path.relative_to(BENCH).parts:
            assert "nmf_toolbox_tpu_torch" not in tops, path
            assert tops <= {"__future__", "contextlib", "numpy", "torch"}, (path, tops)


# --- faults: the timed path broken underneath, `correct` comes out false ------

def _unchanged_state(monkeypatch):
    nmf_mod = importlib.import_module("nmf_toolbox_tpu_torch.models.nmf")
    make = nmf_mod._make_step

    def broken(*a, **k):
        step = make(*a, **k)
        return lambda carry, i: (carry,) + tuple(step(carry, i)[1:])
    monkeypatch.setattr(nmf_mod, "_make_step", broken)


def _half_the_columns(monkeypatch):
    from nmf_toolbox_tpu_torch.ops.kernels import fused as fk
    real = fk.phi_dot_ht

    def half(V, W, H, mode):
        h = V.shape[1] // 2
        return 2.0 * real(V[:, :h].contiguous(), W, H[:, :h].contiguous(), mode)
    monkeypatch.setattr(fk, "phi_dot_ht", half)


def _altered_answer(monkeypatch):
    real = nt.nmf

    def altered(*a, **k):
        res = real(*a, **k)
        res.H = res.H * 1.01
        return res
    monkeypatch.setattr(nt, "nmf", altered)


@pytest.mark.parametrize("fault", [_unchanged_state, _half_the_columns, _altered_answer])
def test_a_broken_timed_path_is_not_correct(tmp_path, capsys, monkeypatch, fault):
    root = support.make_root(tmp_path, cells=("tinykl.fused",))
    fault(monkeypatch)
    assert run_line(capsys, root, "tinykl.fused")["correct"] is False


def test_masked_cell_runs_correct(tmp_path, capsys):
    root = support.make_root(tmp_path, cells=("tinykl.masked",))
    line = run_line(capsys, root, "tinykl.masked")
    assert line["correct"] is True


@pytest.mark.parametrize("fault", [None, "no_exchange"])
def test_mesh_of_four_cpu_ranks(tmp_path, capsys, monkeypatch, fault):
    """Four Gloo ranks on the CPU: correct, and not correct once the
    exchange between the ranks is left out."""
    root = support.make_root(tmp_path, cells=("tinyeuc.mesh4",))
    monkeypatch.setenv("PYTHONPATH", str(support.REPO))
    if fault:
        real = harness.rank_command

        def with_fault(*a):
            cmd = real(*a)
            script = Path(cmd[1]).parent / "tests" / "fault_rank.py"
            return [cmd[0], str(script), fault] + cmd[2:]
        monkeypatch.setattr(harness, "rank_command", with_fault)
    line = run_line(capsys, root, "tinyeuc.mesh4", seconds=0.5)
    assert line["correct"] is (fault is None)
    assert line["device"]["count"] == 4


def test_control_readings_on_the_cpu(tmp_path):
    """control.py's readings at a test size: the program stands near the
    reference (on the CPU TF32 does not exist, so the control equals it)."""
    from nmfbench import control
    root = support.make_root(tmp_path, cells=("tinykl.fused",))
    row = control.readings(cells.load("tinykl.fused", root), SEED, torch.device("cpu"))
    assert row["program"]["W_gap"] < 1e-4 and row["program"]["stop_breaks"] == 0
    assert row["control"]["W_gap"] == 0.0


# --- the control on the card ----------------------------------------------------

def test_control_in_tf32_is_not_correct(card):
    """The reference in TF32 in the program's place fails the limits the
    reference in f32 meets (a test size of kl40k's traffic)."""
    cell = cells.load("kl40k.fused")
    cfg = dict(cell.config, m=4000, n=2000)
    tr = cell.traffic
    V, parts = data.make_v(cfg, tr, 5, card)
    tol = data.tolerance(cfg, tr, V, parts)
    W0, H0 = data.make_init(cfg, 5, 0, card)
    ctl = mu.solve(V, W0, H0, "kl", tol, tr["cap"], tf32=True)
    n = ctl["n_iters"] or tr["cap"]
    ref = mu.solve(V, W0, H0, "kl", tol, tr["cap"], snapshots=(n,))
    nums = check.trajectory_gaps(torch, ctl["cost"][:n], n, ctl["W"], ctl["H"], ref)
    nums["stop_breaks"] = 0
    assert check.judge(nums, tr["limits"])[0] is False
