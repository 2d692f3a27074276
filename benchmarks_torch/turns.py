#!/usr/bin/env python3
"""Time the PyTorch + CUDA port's fused kernels and fused nmf for one source tree.

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
(100 000x10 000 r200, 20 sweeps after a 2-sweep warm-up).  Timing only:
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
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
