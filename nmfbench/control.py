"""Readings for the limits of ``check.py``: the program and the control,
seed by seed, at a cell's own size, in one process.

    python3 nmfbench/control.py --workload <cell> --seeds 1 2 3

For each seed it makes the cell's V (and M) and tolerance as a run does,
and for solve 0's init it sets beside the plain reference that the
configuration names (TF32 off):

* the program (the solver's entry point as the cell calls it, on one
  card): the lower reading of each number;
* the control: the reference put in the program's place and run with
  TF32 products, the nearest precision below the configuration's f32:
  the upper reading.

Prints one JSON line per seed and a summary (the largest program
reading and the smallest control reading of each number).  Not run by
the benchmark's runs.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from nmfbench import cells, check, data, harness  # noqa: E402


def readings(cell, seed, device):
    import torch
    cfg, tr = cell.config, cell.traffic
    V, parts = data.make_v(cfg, tr, seed, device)
    M = data.make_mask(cfg, tr, seed, device)
    tol = data.tolerance(cfg, tr, V, parts, M, cell.solver)
    del parts
    init = data.make_init(cfg, seed, 0, device, cell.solver)
    cap = int(tr["cap"])
    out, runs = {"seed": seed}, {}
    t0 = time.perf_counter()
    res = harness.program_solve(cell, V, init, tol, M, None)
    out["program_s"] = time.perf_counter() - t0
    runs["program"] = (res.cost, int(res.n_iters), bool(res.converged), res.W, res.H)
    del res
    t0 = time.perf_counter()
    ctl = cell.solver.reference_solve(cell.reference, cfg, tr, V, init, tol, M=M, tf32=True)
    out["control_s"] = time.perf_counter() - t0
    n_c = ctl["n_iters"] or cap
    runs["control"] = (ctl["cost"][:n_c], n_c, ctl["n_iters"] is not None, ctl["W"], ctl["H"])
    del ctl
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = cell.solver.reference_solve(cell.reference, cfg, tr, V, init, tol, M=M,
                                      snapshots=[r[1] for r in runs.values()])
    out["reference_s"] = time.perf_counter() - t0
    out["reference_n_iters"] = ref["n_iters"]
    for name, (cost, n, stopped, W, H) in runs.items():
        nums = check.trajectory_gaps(torch, cost, n, W, H, ref)
        nums["stop_breaks"] = check.stop_breaks(cost, n, stopped, tol)
        nums["n_iters"] = n
        out[name] = nums
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    import torch
    harness.cache_env(cells.ROOT)
    cell = cells.load(args.workload)
    if not torch.cuda.is_available():
        print("nmfbench control: no CUDA card", file=sys.stderr)
        return 2
    rows = []
    for seed in args.seeds:
        row = readings(cell, seed, torch.device("cuda", 0))
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {}
    for name in check.NUMBERS:
        summary[f"program_max_{name}"] = max(r["program"][name] for r in rows)
        summary[f"control_min_{name}"] = min(r["control"][name] for r in rows)
    print(json.dumps({"workload": args.workload, "seeds": args.seeds, **summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
