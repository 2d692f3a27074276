"""Find a cell's files by the names in ``BENCHMARK.json``.

Nothing about one configuration, traffic mix or metric is written in
code: a cell is an entry of ``workloads``; its configuration is the file
its ``configs`` entry names; its traffic mix is
``nmfbench/traffic/<traffic>.json``; each metric is a reader
``nmfbench/metrics/<name>.py`` that defines ``UNIT`` and
``read(run) -> float | None`` (None: nothing to read, the metric is left
out of the line).  A new cell, mix or metric is new files and entries.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


class Cell:
    def __init__(self, name, workload, config, traffic, end_to_end, per_layer, bench_dir):
        self.name = name
        self.chips = int(workload["chips"])
        self.config = config
        self.traffic = traffic
        self.end_to_end = end_to_end  # [(spec, reader module)]
        self.per_layer = per_layer
        self.bench_dir = bench_dir


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reader(bench_dir: Path, name: str):
    """The reader module of metric ``name``."""
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "nmfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r} at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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
                _metrics(bench["per_layer"], cell, bench_dir), bench_dir)
