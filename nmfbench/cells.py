"""Find a cell's files by the names in ``BENCHMARK.json``.

Nothing about one configuration, traffic mix, solver or metric is written
in code: a cell is an entry of ``workloads``; its configuration is the
file its ``configs`` entry names; its traffic mix is
``nmfbench/traffic/<traffic>.json``; each metric is a reader
``nmfbench/metrics/<name>.py`` that defines ``UNIT`` and
``read(run) -> float | None`` (None: nothing to read, the metric is left
out of the line).  The configuration's ``"solver"`` (``nmf`` where it
has none) names ``nmfbench/solvers/<solver>.py``, which calls the
port's entry point and knows its inits, least work and planted cost
(see ``solvers/nmf.py``), and its ``"reference"`` names the file of the
plain reference, relative to the root.  A new cell, mix, solver or
metric is new files and entries.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
DEFAULT_SOLVER = "nmf"  # the solver of a configuration with no "solver" key


class Cell:
    def __init__(self, name, workload, config, traffic, end_to_end, per_layer, bench_dir,
                 solver, reference):
        self.name = name
        self.chips = int(workload["chips"])
        self.config = config
        self.traffic = traffic
        self.solver = solver  # the module solvers/<solver>.py
        self.reference = reference  # the module of the plain reference
        self.end_to_end = end_to_end  # [(spec, reader module)]
        self.per_layer = per_layer
        self.bench_dir = bench_dir


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: Path, prefix: str, what: str):
    """The Python file at ``path``, loaded as a module of its own."""
    name = prefix + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no {what} at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(bench_dir: Path, name: str):
    """The reader module of metric ``name``."""
    return _module(bench_dir / "metrics" / f"{name}.py", "nmfbench_metric_",
                   f"reader for metric {name!r}")


def solver(config: dict, bench_dir: Path = BENCH_DIR):
    """The solver module of a configuration: ``solvers/<solver>.py``."""
    name = config.get("solver", DEFAULT_SOLVER)
    return _module(Path(bench_dir) / "solvers" / f"{name}.py", "nmfbench_solver_",
                   f"solver module for {name!r}")


def reference(config: dict, root: Path = ROOT):
    """The plain reference the configuration names, relative to ``root``."""
    return _module(Path(root) / config["reference"], "nmfbench_reference_",
                   "plain reference")


def _metrics(specs, cell, bench_dir):
    out = []
    for spec in specs:
        if "workloads" in spec and cell not in spec["workloads"]:
            continue
        mod = reader(bench_dir, spec["name"])
        if mod.UNIT != spec["unit"]:
            raise ValueError(f"metric {spec['name']!r}: BENCHMARK.json says unit "
                             f"{spec['unit']!r}, its reader {mod.UNIT!r}")
        out.append((spec, mod))
    return out


def load(cell: str, root: Path = ROOT, bench_dir: Path | None = None) -> Cell:
    """The cell named ``cell`` of ``root``'s BENCHMARK.json, its files read."""
    root = Path(root)
    bench_dir = Path(bench_dir) if bench_dir is not None else root / BENCH_DIR.name
    bench = load_json(root / "BENCHMARK.json")
    work = {w["name"]: w for w in bench["workloads"]}
    if cell not in work:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json; have {sorted(work)}")
    w = work[cell]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(bench_dir / "traffic" / f"{w['traffic']}.json")
    if traffic["config"] != w["config"]:
        raise ValueError(f"traffic {w['traffic']!r} is for config {traffic['config']!r}, "
                         f"the cell names {w['config']!r}")
    if int(traffic["chips"]) != int(w["chips"]):
        raise ValueError(f"traffic {w['traffic']!r} runs on {traffic['chips']} chips, "
                         f"the cell asks for {w['chips']}")
    return Cell(cell, w, config, traffic, _metrics(bench["end_to_end"], cell, bench_dir),
                _metrics(bench["per_layer"], cell, bench_dir), bench_dir,
                solver(config, bench_dir), reference(config, root))
