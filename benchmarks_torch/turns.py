#!/usr/bin/env python3
"""Time the PyTorch + CUDA port's kernels and the solvers that run them, for one source tree.

    python benchmarks_torch/turns.py [--root DIR]

Imports ``nmf_toolbox_tpu_torch`` from DIR (default: this checkout) and
builds its kernels.  At chip_smoke.py's main shape (40 000x10 000 k=100
f32) it times each fused kernel in both modes (``chip_smoke.cuda_ms``:
mean of 10 launches by CUDA events, after a warm-up); at each of the
W-phase comparison's shapes (``chip_smoke.COMPARE``, inputs as phase 6
makes them) the plain composition, ``phi_dot_ht`` and
``kl_phi_dot_ht_dma`` likewise; then ``nmf(method="fused")`` KL and IS
(host clock around 10 synchronised iterations, after a 2-iteration
warm-up), and ``chip_smoke.profile_device_ms`` over one more fused KL
run; last, ``nmf_hals`` at chip_smoke.py's phase 7 shape and inputs
(100 000x10 000 r200, 20 sweeps after a 2-sweep warm-up).  Then the
Hoyer projection (``hoyer_project``, 48 passes allowed) at H's 50 rows
of 2000 (BASELINE #2) and at W's 200 columns of 100 000 given as rows
of a strided W.mT view (phase 7's width), f32 and f64, inputs as
chip_smoke.py phase 18 makes them: the device µs a call
(``chip_smoke.kernel_device_ms``: CUDA events around calls queued
behind a device sleep, the wrapper's copy included, and the kernel's
own µs a launch from the profiler), the ms a call by CUDA events over
20 back-to-back calls, and at H's shape the wrapper's host µs a call
(``chip_smoke.wrapper_host_us``, 200 calls); and the default-dispatch
solvers that project, as chip_smoke.py phase 14 runs them: ``nmfsc`` at
BASELINE #2 (5000x2000 r50, H_sparsity 0.6) and at 100 000x10 000 r200
(W 0.5, H 0.6), ``cnmfsc`` at 513x10 000 r64 T8 (H 0.5): ms, host reads
and ``hoyer_project`` launches per iteration
(``chip_smoke.sparse_timing``) and the device's idle share
(``chip_smoke.profile_device_ms`` over 10 iterations).  Timing only:
each tree's own chip_smoke.py checks its kernels.

Prints one JSON line with the card's name and power limit.  Trees share
the package name, so each tree runs in its own process; to compare two
trees on one card, run this once per tree in turns (parent, change,
change, parent) within one command.  Needs a CUDA card; imports nothing
of JAX.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np

HERE = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
import chip_smoke as cs  # noqa: E402  (this checkout's helpers, whatever --root)

HOYER_SHAPES = (("H 50x2000", (50, 2000), False, 0.6),
                ("W 200x100000", (200, 100_000), True, 0.5))
HOYER_REPS, HOST_REPS = 20, 200


def projection(torch, out):
    """The Hoyer projection kernel's times, and the default solvers that
    run it, into ``out``."""
    import nmf_toolbox_tpu_torch as tt
    from nmf_toolbox_tpu_torch.ops.kernels import hoyer as hk
    from nmf_toolbox_tpu_torch.ops.projection import hoyer_l1_target
    for i, (label, shape, transposed, sp) in enumerate(HOYER_SHAPES):
        k1 = hoyer_l1_target(shape[-1], sp)
        for dtype in (torch.float32, torch.float64):
            S = cs.hoyer_input(torch, shape, transposed, dtype, 180 + i)
            call = (lambda S=S: hk.hoyer_project(S, k1, 1.0, 48))  # noqa: E731
            queued, own, seen = cs.kernel_device_ms(torch, call, HOYER_REPS)
            row = {"device_us": None if own is None else 1e3 * own, "profiler_seen": seen,
                   "queued_us": 1e3 * queued, "event_ms": cs.cuda_ms(torch, call, HOYER_REPS)}
            if not transposed:
                row["host_us"] = cs.wrapper_host_us(torch, call, HOST_REPS)
            out[f"hoyer {label} {str(dtype).split('.')[-1]}"] = row
            del S

    m, n, k = cs.SPARSE_BASE
    g = torch.Generator(device="cuda").manual_seed(15)
    V = 0.1 + 0.9 * torch.rand((m, n), generator=g, device="cuda")
    W0, H0 = (torch.rand(s, generator=g, device="cuda") for s in ((m, k), (k, n)))
    runs = {f"nmfsc H 0.6 {m}x{n} r{k}": (lambda it: tt.nmfsc(
        V, k, W_init=W0, H_init=H0, H_sparsity=0.6, maxiter=it, tolerance=cs.NEVER))}
    m, n, k, T = cs.CONV
    g = torch.Generator(device="cuda").manual_seed(17)
    Vc = 0.1 + 0.9 * torch.rand((m, n), generator=g, device="cuda")
    W3 = 0.1 + 0.9 * torch.rand((m, k, T), generator=g, device="cuda")
    H3 = torch.rand((k, n), generator=g, device="cuda")
    runs[f"cnmfsc H 0.5 {m}x{n} r{k} T{T}"] = (lambda it: tt.cnmfsc(
        Vc, k, T, W_init=W3, H_init=H3, H_sparsity=0.5, maxiter=it, tolerance=cs.NEVER))
    m, n, k = cs.GRAM
    Vb = 0.05 + 0.95 * torch.rand((m, n), generator=torch.Generator(device="cuda").manual_seed(0),
                                  device="cuda")
    g = torch.Generator(device="cuda").manual_seed(16)
    Wb, Hb = (torch.rand(s, generator=g, device="cuda") for s in ((m, k), (k, n)))
    runs[f"nmfsc W 0.5 H 0.6 {m}x{n} r{k}"] = (lambda it: tt.nmfsc(
        Vb, k, W_init=Wb, H_init=Hb, W_sparsity=0.5, H_sparsity=0.6, maxiter=it,
        tolerance=cs.NEVER))
    for name, call in runs.items():
        row, _ = cs.sparse_timing(torch, name, call, phase="turns",
                                  launches=lambda: hk.hoyer_project_launches)
        prof = cs.profile_device_ms(torch, lambda: call(cs.ITERS), cs.ITERS)
        row.update(idle_share=prof["idle_share"], busy_ms_per_iter=prof["busy_ms_per_iter"],
                   kernels_per_iter=prof["kernels_per_iter"])
        out[name] = row


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("turns: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    from nmf_toolbox_tpu_torch import nmf, nmf_hals
    from nmf_toolbox_tpu_torch.ops.kernels import _build
    from nmf_toolbox_tpu_torch.ops.kernels import fused as fk
    from nmf_toolbox_tpu_torch.ops.kernels import fused_dma as dk
    t0 = time.perf_counter()
    _build.load()
    out = {"root": args.root, "build_s": time.perf_counter() - t0, "card": cs.card()}

    m, n, k = cs.MAIN
    rng = np.random.default_rng(0)
    V, W, H = (torch.from_numpy(rng.uniform(0.1, 1, s).astype(np.float32)).cuda()
               for s in ((m, n), (m, k), (k, n)))
    for name, _ in cs.KERNELS:
        for mode in ("kl", "is"):
            fn = getattr(fk, name)
            out[f"{name}_{mode}_ms"] = cs.cuda_ms(torch, lambda: fn(V, W, H, mode), 10)
    del W, H
    for si, (m2, n2, k2) in enumerate(cs.COMPARE):
        g = np.random.default_rng(si)
        V2, W2, H2 = (torch.from_numpy(g.uniform(0.05, 1.0, s).astype(np.float32)).cuda()
                      for s in ((m2, n2), (m2, k2), (k2, n2)))
        for name, fn in (("plain", lambda: dk.kl_phi_dot_ht_dma_reference(V2, W2, H2)),
                         ("phi_dot_ht", lambda: fk.phi_dot_ht(V2, W2, H2, "kl")),
                         ("dma", lambda: dk.kl_phi_dot_ht_dma(V2, W2, H2))):
            out[f"wphase_{m2}x{n2}r{k2}_{name}_ms"] = cs.cuda_ms(torch, fn, 10)
        del V2, W2, H2
    W0 = rng.uniform(size=(m, k)).astype(np.float32)
    H0 = rng.uniform(size=(k, n)).astype(np.float32)
    kw = dict(W_init=W0, H_init=H0, tolerance=1e-30, method="fused", device="cuda")
    for d in ("kl", "is"):
        nmf(V, k, divergence=d, maxiter=2, **kw)
        res, ms = cs.wall_ms(torch, lambda: nmf(V, k, divergence=d, maxiter=cs.ITERS, **kw))
        out[f"fused_{d}_ms_per_iter"] = ms / cs.ITERS
        out[f"fused_{d}_final_cost"] = float(np.asarray(res.cost)[-1])
    out["profile_fused_kl"] = cs.profile_device_ms(
        torch, lambda: nmf(V, k, divergence="kl", maxiter=cs.ITERS, **kw), cs.ITERS)
    del V
    m, n, k = cs.GRAM
    V = 0.05 + 0.95 * torch.rand((m, n), generator=torch.Generator(device="cuda").manual_seed(0),
                                 device="cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    W0, H0 = (torch.rand(s, generator=g, device="cuda") for s in ((m, k), (k, n)))
    nmf_hals(V, k, W_init=W0, H_init=H0, maxiter=2, tolerance=1e-30)
    _, ms = cs.wall_ms(torch, lambda: nmf_hals(V, k, W_init=W0, H_init=H0,
                                               maxiter=cs.HALS_ITERS, tolerance=1e-30))
    out["hals_ms_per_iter"] = ms / cs.HALS_ITERS
    del V, W0, H0
    projection(torch, out)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
