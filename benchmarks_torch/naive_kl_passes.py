#!/usr/bin/env python3
"""Time the naive KL step's field and cost kernels on the card.

    python benchmarks_torch/naive_kl_passes.py

At 40 000x10 000 f32 (the ``kl40k`` configuration's V; V and V_hat
uniform(0.05, 2), M {0, 1} with 20 % zeros, as ``nmfbench/data.py``
makes the mask), it times ``kl_field`` (weighted: the unweighted field
is one torch pass) and ``kl_cost_terms``, weighted and unweighted
(``ops/kernels/naive_kl.py``), and their plain versions
(the torch chains of ``ops/divergence.py``) by ``chip_smoke.cuda_ms``
(20 launches after a warm-up), in two rounds, in turns, beside each
kernel's byte bound at 3.35 TB/s: one read of each input and one write
of the field.  It checks the field ``torch.equal`` to the chain and the
cost against an f64 sum, then times the weighted naive step end to end:
``nmf(..., weights=M)`` r100, 20 iterations, with the kernels and with
the wrappers swapped for their plain versions, in turns (kernels,
plain, plain, kernels): CUDA events around the whole call, over its
iterations.  Each line is JSON with the card's name and power limit;
the first holds nvcc's registers and spills of ``csrc/naive_kl.cu``'s
kernels.  Needs a CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import json
import pathlib
import sys

import numpy as np

HERE = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
import chip_smoke as cs  # noqa: E402

SHAPE = (40_000, 10_000)
RANK, STEP_ITERS = 100, 20
HBM = 3.35e12  # bytes/s, NVIDIA's data sheet, H100 SXM5
REPS = 20


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("naive_kl_passes: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    import nmf_toolbox_tpu_torch as tt
    from nmf_toolbox_tpu_torch.ops.kernels import _build
    from nmf_toolbox_tpu_torch.ops.kernels import naive_kl as nk
    lib_path = _build.build()
    log = lib_path.with_suffix(".log").read_text().splitlines()
    ptxas = [line.strip() for i, line in enumerate(log)
             if ("registers" in line or "spill" in line)
             and any("naive_kl" in prev for prev in log[max(0, i - 3):i + 1])]
    card = cs.card()
    print(json.dumps({"card": card, "ptxas": ptxas}), flush=True)

    m, n = SHAPE
    g = np.random.default_rng(0)
    V = torch.from_numpy(g.uniform(0.05, 2, SHAPE).astype(np.float32)).cuda()
    Vh = torch.from_numpy(g.uniform(0.05, 2, SHAPE).astype(np.float32)).cuda()
    M = torch.from_numpy((g.uniform(size=SHAPE) >= 0.2).astype(np.float32)).cuda()
    for weighted in (True, False):
        Mw = M if weighted else None
        t = V * torch.log(V / Vh) - V + Vh
        if weighted:
            t = torch.where(Mw > 0, Mw * t, torch.zeros((), device=t.device))
        exact = float(torch.sum(t.double()))
        del t
        cost = float(nk.kl_cost_terms(V, Vh, Mw))
        inputs = 3 if weighted else 2
        rows = {"kl_cost_terms": {"bytes": 4 * m * n * inputs, "fn": nk.kl_cost_terms,
                                  "plain": nk.kl_cost_terms_reference}}
        if weighted:
            phi = nk.kl_field(V, Vh, Mw)
            equal = bool(torch.equal(phi, nk.kl_field_reference(V, Vh, Mw)))
            del phi
            rows["kl_field"] = {"bytes": 4 * m * n * (inputs + 1), "fn": nk.kl_field,
                                "plain": nk.kl_field_reference, "equal_to_chain": equal}
        for name, row in rows.items():
            fn, plain = row.pop("fn"), row.pop("plain")
            row["ms"], row["plain_ms"] = [], []
            for _ in range(2):
                row["ms"].append(cs.cuda_ms(torch, lambda: fn(V, Vh, Mw), REPS))
                row["plain_ms"].append(cs.cuda_ms(torch, lambda: plain(V, Vh, Mw), REPS))
            row["bound_ms"] = row["bytes"] / HBM * 1e3
            row["pct_of_bound"] = 100 * row["bound_ms"] / min(row["ms"])
        rows["kl_cost_terms"]["rel_gap_to_f64"] = abs(cost - exact) / abs(exact)
        print(json.dumps({"card": card, "shape": f"{m}x{n}", "weighted": weighted,
                          **rows}), flush=True)
    del Vh

    W0 = torch.from_numpy(g.uniform(0.1, 1, (m, RANK)).astype(np.float32)).cuda()
    H0 = torch.from_numpy(g.uniform(0.1, 1, (RANK, n)).astype(np.float32)).cuda()
    saved = nk.kl_field, nk.kl_cost_terms

    def step_ms(kernels):
        nk.kl_field, nk.kl_cost_terms = (saved if kernels else
                                         (nk.kl_field_reference, nk.kl_cost_terms_reference))
        try:
            def run():
                return tt.nmf(V, RANK, W_init=W0, H_init=H0, weights=M, divergence="kl",
                              maxiter=STEP_ITERS, tolerance=0.0)
            run()  # warm-up: allocator, cuBLAS handles
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            r = run()
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / STEP_ITERS, r
        finally:
            nk.kl_field, nk.kl_cost_terms = saved

    out, factors = {"kernels": [], "plain": []}, {}
    for kernels in (True, False, False, True):
        ms, r = step_ms(kernels)
        out["kernels" if kernels else "plain"].append(ms)
        factors.setdefault(kernels, (r.W, r.H))
    same = all(torch.equal(a, b) for a, b in zip(factors[True], factors[False]))
    print(json.dumps({"card": card, "step": f"nmf weighted kl {m}x{n} r{RANK}",
                      "ms_per_iter": out, "W_H_equal": same}), flush=True)


if __name__ == "__main__":
    main()
