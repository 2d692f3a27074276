#!/usr/bin/env python3
"""On-card smoke run of nmf_toolbox_tpu_torch, the PyTorch + CUDA port.

Run from the repository root on a machine with one CUDA card (Hopper,
sm_90a) and the CUDA toolkit:

    python3 chip_smoke.py

Phases, one line each; any failure raises and the script exits non-zero
without printing the last line:

0. device check (no CUDA device: exit 1), the card's name and power
   limit from nvidia-smi, TF32 off for matmuls and cuDNN;
1. build the CUDA kernels from csrc/ with nvcc;
2. each kernel in both modes against its plain PyTorch version on the
   card at 300x700 k=40, 40 000x10 000 k=100 and 2 000x3 000 k=1024:
   max relative error <= 1e-4 (tests/test_pallas.py's f32 threshold),
   cost_terms bit-identical over two runs, kernel and plain times;
3. the main path, ``nmf(method="fused")`` at 40 000x10 000 rank 100 f32,
   KL and IS, 10 iterations, with every kernel's launch counter set to 0
   before and required above 0 after; costs finite, KL non-increasing,
   and within rtol 2e-3 of ``method="naive"`` on the same inits
   (test_fused_solver_matches_naive's threshold); ms/iteration of both;
4. the default Euclidean ``gram`` path at 100 000x10 000 rank 200 f32,
   10 iterations (no kernel of its own: two cuBLAS GEMMs per iteration);
5. bench.py's objective check: f32 port vs the f64 NumPy oracle at
   1000x500 rank 25 over 200 iterations, within 1e-5 relative.

Then a JSON line of per-kernel results and, last, the device line.
Imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

KERNELS = (("phi_dot_ht", "nmf_toolbox_tpu/ops/pallas/fused.py:128"),
           ("wt_dot_phi", "nmf_toolbox_tpu/ops/pallas/fused.py:218"),
           ("cost_terms", "nmf_toolbox_tpu/ops/pallas/fused.py:292"))
SOURCE = "nmf_toolbox_tpu_torch/csrc/fused.cu"
CHECK_SHAPES = ((300, 700, 40), (40_000, 10_000, 100), (2_000, 3_000, 1024))
MAIN = (40_000, 10_000, 100)   # the KL shape of models/nmf.py:316-321
GRAM = (100_000, 10_000, 200)  # bench.py's headline shape
REL_TOL = 1e-4        # tests/test_pallas.py, f32 path
SOLVER_RTOL = 2e-3    # tests/test_pallas.py::test_fused_solver_matches_naive
ORACLE_RTOL = 1e-5    # bench.py objective check
ITERS = 10


def say(msg):
    print(msg, flush=True)


def as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def rel_err(a, b):
    """max |a - b| / max(|b|, 1e-6), in f64 (test_pallas.py's measure)."""
    a, b = a.double(), b.double()
    return float(((a - b).abs() / b.abs().clamp_min(1e-6)).max())


def cuda_ms(torch, fn, reps):
    """Mean ms of ``fn`` over ``reps`` back-to-back calls, by CUDA events,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase0_device(torch):
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA card", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    say(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"phase 0 device: {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")


def phase1_build():
    from nmf_toolbox_tpu_torch.ops.kernels import _build
    t0 = time.perf_counter()
    _build.load()
    say(f"phase 1 build: {time.perf_counter() - t0:.2f} s "
        f"({_build.library_path().name})")


def phase2_kernels(torch, fk, main_V):
    stats = {name: {"max_abs_err": 0.0, "max_rel_err": 0.0} for name, _ in KERNELS}
    rng = np.random.default_rng(1)
    for (m, n, k) in CHECK_SHAPES:
        if (m, n) == MAIN[:2]:
            V = main_V
        else:
            V = torch.from_numpy(rng.uniform(0.1, 1, (m, n)).astype(np.float32)).cuda()
        W = torch.from_numpy(rng.uniform(0.1, 1, (m, k)).astype(np.float32)).cuda()
        H = torch.from_numpy(rng.uniform(0.1, 1, (k, n)).astype(np.float32)).cuda()
        for name, _ in KERNELS:
            fn = getattr(fk, name)
            ref = getattr(fk, f"{name}_reference")
            for mode in ("kl", "is"):
                got = as_tuple(fn(V, W, H, mode))
                torch.cuda.synchronize()
                want = as_tuple(ref(V, W, H, mode))
                rel = max(rel_err(a, b) for a, b in zip(got, want))
                abs_ = max(float((a.double() - b.double()).abs().max())
                           for a, b in zip(got, want))
                if not rel <= REL_TOL:
                    raise AssertionError(f"{name} {mode} at {m}x{n} k={k}: max "
                                         f"relative error {rel:.3g} > {REL_TOL}")
                if name == "cost_terms":
                    again = as_tuple(fn(V, W, H, mode))
                    if not all(torch.equal(a, b) for a, b in zip(got, again)):
                        raise AssertionError(f"cost_terms {mode} at {m}x{n} k={k}: "
                                             "two runs differ in their bits")
                s = stats[name]
                s["max_abs_err"] = max(s["max_abs_err"], abs_)
                s["max_rel_err"] = max(s["max_rel_err"], rel)
                line = f"phase 2 {name} {mode} {m}x{n} k={k}: rel {rel:.3g}, abs {abs_:.3g}"
                if (m, n, k) == MAIN:
                    ms = cuda_ms(torch, lambda: fn(V, W, H, mode), 5)
                    plain = cuda_ms(torch, lambda: ref(V, W, H, mode), 5)
                    suffix = "" if mode == "kl" else "_is"
                    s["ms" + suffix], s["plain_ms" + suffix] = ms, plain
                    line += f", kernel {ms:.3f} ms, plain {plain:.3f} ms"
                say(line)
        del V, W, H
    return stats


def phase3_main_path(torch, fk, nmf, V, W0, H0):
    k = MAIN[2]
    kw = dict(W_init=W0, H_init=H0, maxiter=ITERS, tolerance=1e-30, device="cuda")
    for d in ("kl", "is"):  # warm both paths (allocator, cuBLAS handles)
        nmf(V, k, divergence=d, method="fused", **{**kw, "maxiter": 2})
        nmf(V, k, divergence=d, method="naive", **{**kw, "maxiter": 2})
    out = {}
    for d in ("kl", "is"):
        fk.phi_dot_ht_launches = fk.wt_dot_phi_launches = fk.cost_terms_launches = 0
        fused, ms_fused = wall_ms(torch, lambda: nmf(V, k, divergence=d, method="fused", **kw))
        launches = {name: getattr(fk, f"{name}_launches") for name, _ in KERNELS}
        if not all(c > 0 for c in launches.values()):
            raise AssertionError(f"fused {d} run missed a kernel: {launches}")
        naive, ms_naive = wall_ms(torch, lambda: nmf(V, k, divergence=d, method="naive", **kw))
        cf, cn = np.asarray(fused.cost), np.asarray(naive.cost)
        if fused.n_iters != ITERS or not np.all(np.isfinite(cf)):
            raise AssertionError(f"fused {d}: n_iters {fused.n_iters}, cost {cf}")
        if d == "kl" and not np.all(np.diff(cf) <= 0):
            raise AssertionError(f"fused kl cost increased: {cf}")
        if not np.allclose(cf, cn, rtol=SOLVER_RTOL, atol=0):
            raise AssertionError(f"fused vs naive {d} cost: {cf} vs {cn}")
        for name in ("W", "H"):
            x = getattr(fused, name)
            if x.device.type != "cuda" or not bool(torch.isfinite(x).all()):
                raise AssertionError(f"fused {d} {name} not finite on the card")
        out[d] = {"launches": launches, "ms_per_iter_fused": ms_fused / ITERS,
                  "ms_per_iter_naive": ms_naive / ITERS}
        say(f"phase 3 nmf {d} {MAIN[0]}x{MAIN[1]} r{k}: fused "
            f"{ms_fused / ITERS:.2f} ms/iter, naive {ms_naive / ITERS:.2f} ms/iter, "
            f"launches {launches}, final cost fused {cf[-1]:.7g} naive {cn[-1]:.7g}")
    return out


def phase4_gram(torch, nmf):
    m, n, k = GRAM
    g = torch.Generator(device="cuda").manual_seed(0)
    V = 0.05 + 0.95 * torch.rand((m, n), generator=g, device="cuda")
    W0 = torch.rand((m, k), generator=g, device="cuda")
    H0 = torch.rand((k, n), generator=g, device="cuda")
    kw = dict(W_init=W0, H_init=H0, tolerance=1e-30)
    nmf(V, k, maxiter=2, **kw)
    res, ms = wall_ms(torch, lambda: nmf(V, k, maxiter=ITERS, **kw))
    c = np.asarray(res.cost)
    if res.n_iters != ITERS or not np.all(np.isfinite(c)) or not np.all(np.diff(c) <= 0):
        raise AssertionError(f"gram path: n_iters {res.n_iters}, cost {c}")
    say(f"phase 4 nmf euclidean gram {m}x{n} r{k}: {ms / ITERS:.2f} ms/iter, "
        f"final cost {c[-1]:.7g}")
    return ms / ITERS


def phase5_objective(torch, nmf):
    """bench.py:55-88 on the card: literal nmf.m Euclidean updates in f64
    NumPy against the port's f32 run."""
    rng = np.random.default_rng(42)
    V = rng.uniform(0.05, 1.0, (1000, 500))
    W0 = rng.uniform(size=(1000, 25))
    H0 = rng.uniform(size=(25, 500))
    eps = np.finfo(np.float64).eps
    W, H = W0 / np.sqrt((W0 ** 2).sum(0, keepdims=True)), H0.copy()
    for _ in range(200):
        Vh = W @ H
        neg = V @ H.T + W * np.diag(H @ Vh.T @ W)[None, :]
        pos = Vh @ H.T + W * np.diag(H @ V.T @ W)[None, :]
        W = W * (neg / np.maximum(pos, eps))
        W = W / np.sqrt((W ** 2).sum(0, keepdims=True))
        Vh = W @ H
        H = H * ((W.T @ V) / np.maximum(W.T @ Vh, eps))
    c_oracle = 0.5 * np.sum((V - W @ H) ** 2)
    r = nmf(V.astype(np.float32), 25, W_init=W0.astype(np.float32),
            H_init=H0.astype(np.float32), maxiter=200, tolerance=1e-30,
            device="cuda")
    Wf, Hf = (x.cpu().numpy().astype(np.float64) for x in (r.W, r.H))
    rel = abs(0.5 * np.sum((V - Wf @ Hf) ** 2) - c_oracle) / c_oracle
    if not rel <= ORACLE_RTOL:
        raise AssertionError(f"objective {rel:.3g} from the f64 oracle > {ORACLE_RTOL}")
    say(f"phase 5 objective check 1000x500 r25: {rel:.3g} relative to the f64 oracle")
    return rel


def main():
    import torch
    phase0_device(torch)
    phase1_build()
    from nmf_toolbox_tpu_torch import nmf
    from nmf_toolbox_tpu_torch.ops.kernels import fused as fk

    m, n, k = MAIN
    rng = np.random.default_rng(0)
    V = torch.from_numpy(rng.uniform(0.1, 1, (m, n)).astype(np.float32)).cuda()
    W0 = rng.uniform(size=(m, k)).astype(np.float32)
    H0 = rng.uniform(size=(k, n)).astype(np.float32)

    stats = phase2_kernels(torch, fk, V)
    main_path = phase3_main_path(torch, fk, nmf, V, W0, H0)
    del V
    torch.cuda.empty_cache()
    phase4_gram(torch, nmf)
    phase5_objective(torch, nmf)

    kernels = []
    for name, replaces in KERNELS:
        s = stats[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
            "launches": sum(main_path[d]["launches"][name] for d in ("kl", "is")),
            "max_abs_err": s["max_abs_err"], "max_rel_err": s["max_rel_err"],
            "ms": s["ms"], "plain_ms": s["plain_ms"],
            "ms_is": s["ms_is"], "plain_ms_is": s["plain_ms_is"],
        })
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
