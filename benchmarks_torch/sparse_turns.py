#!/usr/bin/env python3
"""Time the port's projected-gradient and complex solvers in alternating rounds.

    python benchmarks_torch/sparse_turns.py [--rounds 6]

At chip_smoke.py phase 14's shapes and inputs (f32, TF32 off) each round
runs, in turn: ``nmfsc`` at BASELINE #2 (5000x2000 r50, H_sparsity 0.6)
at line-search widths 0 and 8 (0 first in even rounds, 8 first in odd
ones), ``cnmfsc`` at 513x10 000 r64 T8 with H_sparsity 0.5, and
``cmfwisa`` complex64 at 513x5000 r32 with one source and with 16 + 16.
Each is timed as chip_smoke.py times it (``chip_smoke.sparse_timing`` and
``chip_smoke.per_iter_ms``: ms per iteration from calls of 2 and 22
iterations after a warm-up), so the spread between rounds of one process
stands beside the difference between two settings.

Last, ``cnmfsc`` once more under ``torch.profiler``, over calls of 2 and
22 iterations: the device's busy ms and its kernel launches (kernels,
copies and fills) per iteration are the differences over the 20 extra
iterations, and the device's idle share is set against the same
solver's unprofiled ms per iteration from the rounds (their median), so
the profiler's own host cost does not enter it.

Prints one JSON line with the card's name and power limit, the host's
CPU model and its load average before and after.  Needs a CUDA card;
imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys

import numpy as np

HERE = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
import chip_smoke as cs  # noqa: E402


def cpu_model():
    for line in pathlib.Path("/proc/cpuinfo").read_text().splitlines():
        if line.startswith("model name"):
            return line.split(":", 1)[1].strip()
    return "unknown"


def profiled_per_iter(torch, call, iters):
    """(busy device ms, device launches) per iteration: the differences
    between profiled calls of 2 and 2 + ``iters`` iterations over
    ``iters``."""
    from torch.profiler import ProfilerActivity, profile
    totals = []
    for it in (2, 2 + iters):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            call(it)
            torch.cuda.synchronize()
        busy = launches = 0.0
        for evt in prof.key_averages():
            if str(getattr(evt, "device_type", "")).endswith("CUDA"):
                busy += evt.self_device_time_total / 1e3
                launches += evt.count
        totals.append((busy, launches))
    (b2, n2), (b22, n22) = totals
    return (b22 - b2) / iters, (n22 - n2) / iters


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=6)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("sparse_turns: no CUDA card")
    torch.backends.cuda.matmul.fp32_precision = "ieee"
    import nmf_toolbox_tpu_torch as tt
    out = {"card": cs.card(), "cpu": cpu_model(), "cpus": os.cpu_count(),
           "loadavg_before": os.getloadavg()}

    m, n, k = cs.SPARSE_BASE
    g = torch.Generator(device="cuda").manual_seed(15)
    V = 0.1 + 0.9 * torch.rand((m, n), generator=g, device="cuda")
    W0 = torch.rand((m, k), generator=g, device="cuda")
    H0 = torch.rand((k, n), generator=g, device="cuda")

    def nmfsc(width):
        return lambda it: tt.nmfsc(V, k, W_init=W0, H_init=H0, H_sparsity=0.6, maxiter=it,
                                   tolerance=cs.NEVER, linesearch_width=width)

    cm, cn, ck, T = cs.CONV
    g = torch.Generator(device="cuda").manual_seed(17)
    Vc = 0.1 + 0.9 * torch.rand((cm, cn), generator=g, device="cuda")
    Wc = 0.1 + 0.9 * torch.rand((cm, ck, T), generator=g, device="cuda")
    Hc = torch.rand((ck, cn), generator=g, device="cuda")

    def cnmfsc(it):
        return tt.cnmfsc(Vc, ck, T, W_init=Wc, H_init=Hc, H_sparsity=0.5, maxiter=it,
                         tolerance=cs.NEVER)

    zm, zn, zk = cs.CMF
    g = torch.Generator(device="cuda").manual_seed(18)
    mag = torch.rand((zm, zn), generator=g, device="cuda")
    Z = mag * torch.exp(1j * (2 * torch.rand((zm, zn), generator=g, device="cuda") - 1) * np.pi)
    Wz = torch.rand((zm, zk), generator=g, device="cuda")
    Hz = torch.rand((zk, zn), generator=g, device="cuda")
    h = zk // 2
    cmf = {
        "cmfwisa r32": lambda it: tt.cmfwisa(Z, zk, W_init=Wz, H_init=Hz, maxiter=it,
                                             tolerance=cs.NEVER),
        "cmfwisa r16+16": lambda it: tt.cmfwisa(
            Z, [h, h], W_init=[Wz[:, :h], Wz[:, h:]], H_init=[Hz[:h], Hz[h:]], maxiter=it,
            tolerance=cs.NEVER),
    }

    rounds = []
    for r in range(args.rounds):
        row = {}
        for w in (cs.SPARSE_WIDTHS if r % 2 == 0 else cs.SPARSE_WIDTHS[::-1]):
            t, _ = cs.sparse_timing(torch, f"nmfsc width {w}", nmfsc(w))
            row[f"nmfsc width {w}"] = t["ms_per_iter"]
            row[f"nmfsc width {w} reads"] = t["reads_per_iter"]
        t, _ = cs.sparse_timing(torch, "cnmfsc", cnmfsc)
        row["cnmfsc"] = t["ms_per_iter"]
        row["cnmfsc reads"] = t["reads_per_iter"]
        for name, (ms, _) in cs.per_iter_ms(torch, cmf, iters=cs.SPARSE_ITERS,
                                            phase=14).items():
            row[name] = ms
        rounds.append(row)
        cs.say(f"sparse_turns round {r}: {json.dumps(row)}")
    out["rounds"] = rounds
    out["median"] = {key: float(np.median([row[key] for row in rounds])) for key in rounds[0]}
    out["spread"] = {key: max(row[key] for row in rounds) / min(row[key] for row in rounds)
                     for key in rounds[0] if not key.endswith("reads")}
    diffs = [row[f"nmfsc width {cs.SPARSE_WIDTHS[1]}"] - row[f"nmfsc width {cs.SPARSE_WIDTHS[0]}"]
             for row in rounds]
    out["nmfsc width 8 minus width 0 ms/iter"] = diffs

    busy, launches = profiled_per_iter(torch, cnmfsc, cs.SPARSE_ITERS)
    wall = out["median"]["cnmfsc"]
    out["cnmfsc device"] = {"busy_ms_per_iter": busy, "launches_per_iter": launches,
                            "unprofiled_ms_per_iter": wall, "idle_share": 1 - busy / wall}
    out["loadavg_after"] = os.getloadavg()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
