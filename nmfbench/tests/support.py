"""A throwaway root for the CPU tests: ``nmfbench/`` copied beside a
``BENCHMARK.json`` of tiny cells, each config and traffic a file of its
own, as a later change would add them."""
from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]  # nmfbench/
REPO = HERE.parent

MU = "nmfbench/reference/mu.py"
TINY_CONFIGS = {
    "tinykl": {"m": 60, "n": 48, "k": 6, "divergence": "kl", "dtype": "float32",
               "reference": MU},
    "tinyeuc": {"m": 64, "n": 40, "k": 8, "divergence": "euclidean", "dtype": "float32",
                "reference": MU},
}
GEN = {"planted_rank": 6, "power": 3, "noise": 0.05, "floor": 0.001}
LIMITS = {"cost_gap": 1e-4, "W_gap": 1e-3, "H_gap": 1e-3, "stop_breaks": 0}
TINY_TRAFFIC = {
    "tinykl.fused": {"config": "tinykl", "chips": 1, "method": "fused"},
    "tinyeuc.gram": {"config": "tinyeuc", "chips": 1, "method": None},
    "tinyeuc.mesh4": {"config": "tinyeuc", "chips": 4, "method": None},
    "tinykl.masked": {"config": "tinykl", "chips": 1, "method": None,
                      "mask_zero_share": 0.2},
    "tinykl.default": {"config": "tinykl", "chips": 1, "method": None},
}


def traffic(name, **over):
    t = dict(TINY_TRAFFIC[name])
    t.update({"rel_tol": 3e-4, "cap": 400,
              "assumed": {"generator": dict(GEN)}, "limits": dict(LIMITS)})
    t.update(over)
    return t


def make_root(tmp: Path, cells=("tinykl.fused",), extra_metric=None, **over) -> Path:
    """A root under ``tmp`` holding a copy of nmfbench/ with the real
    metric readers, and a BENCHMARK.json whose cells are ``cells``."""
    root = Path(tmp) / "root"
    shutil.copytree(HERE, root / "nmfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache", "configs", "traffic"))
    (root / "nmfbench" / "configs").mkdir()
    (root / "nmfbench" / "traffic").mkdir()
    real = json.loads((REPO / "BENCHMARK.json").read_text())
    bench = {k: copy.deepcopy(real[k]) for k in ("command", "paths", "run_seconds",
                                                  "end_to_end", "per_layer")}
    bench["configs"], bench["workloads"] = [], []
    for cell in cells:
        t = traffic(cell, **over)
        cfg = t["config"]
        if not any(c["name"] == cfg for c in bench["configs"]):
            path = f"nmfbench/configs/{cfg}.json"
            (root / path).write_text(json.dumps(dict(TINY_CONFIGS[cfg], name=cfg)))
            bench["configs"].append({"name": cfg, "source": "test", "file": path,
                                     "reduced": [], "why": "test"})
        (root / "nmfbench" / "traffic" / f"{cell}.json").write_text(json.dumps(t))
        bench["workloads"].append({"name": cell, "config": cfg, "traffic": cell,
                                   "chips": t["chips"], "why": "test"})
    for group in ("end_to_end", "per_layer"):
        for spec in bench[group]:
            spec.pop("workloads", None)  # every metric in every tiny cell
    if extra_metric:
        bench["per_layer"].append(extra_metric)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
