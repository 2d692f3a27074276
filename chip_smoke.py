#!/usr/bin/env python3
"""On-card smoke run of nmf_toolbox_tpu_torch, the PyTorch + CUDA port.

Run from the repository root on a machine with one CUDA card (Hopper,
sm_90a) and the CUDA toolkit:

    python3 chip_smoke.py

Phases, one line each; any failure raises and the script exits non-zero
without printing the last line:

0. device check (no CUDA device: exit 1), the card's name and power
   limit from nvidia-smi, TF32 off for matmuls and cuDNN;
1. build the CUDA kernels from csrc/ with nvcc; each kernel's registers
   and spills, and for the W- and H-phase kernels (phi_dot_ht,
   wt_dot_phi) the count of tensor-core instructions (HMMA / HGMMA) in the
   library's SASS from ``cuobjdump -sass``, which must not be 0;
2. each kernel in both modes against its plain PyTorch version on the
   card at 300x700 k=40, 40 000x10 000 k=100 and 2 000x3 000 k=1024:
   max relative error <= 1e-4 (tests/test_pallas.py's f32 threshold),
   phase kernels and cost_terms bit-identical over two runs, kernel and
   plain times and the kernel's TFLOP/s (4mnk kl / 6mnk is for the
   phases, 2mnk for cost_terms' V_hat) at the main shape; the
   streamed KL W-phase kernel (kl_phi_dot_ht_dma, k <= 512) likewise at
   300x700 k=40 and the W-phase comparison's three shapes, and a
   ValueError at k=1024;
3. the main path, ``nmf(method="fused")`` at 40 000x10 000 rank 100 f32,
   KL and IS, 10 iterations, with every kernel's launch counter set to 0
   before and required above 0 after; costs finite, KL non-increasing,
   and within rtol 2e-3 of ``method="naive"`` on the same inits
   (test_fused_solver_matches_naive's threshold); ms/iteration of both;
4. the default Euclidean ``gram`` path at 100 000x10 000 rank 200 f32,
   10 iterations (no kernel of its own: two cuBLAS GEMMs per iteration);
5. bench.py's objective check: f32 port vs the f64 NumPy oracle at
   1000x500 rank 25 over 200 iterations, within 1e-5 relative;
6. the W-phase comparison (benchmarks/pallas_compare.py's op and
   shapes): (V / (W H)) @ H' as the plain composition, phi_dot_ht and
   kl_phi_dot_ht_dma, ms by CUDA events, against the one-V-read floor
   from a device-to-device copy measured in the same run;
7. nmf_hals at 100 000x10 000 rank 200 f32: 20 plain sweeps (ms/iter,
   the sweeps' share), 20 extrapolated, bench.py's time-to-tolerance loop
   from random and NNDSVD-seeded inits (seeding inside the clock);
   weighted HALS at 20 000x2 000 rank 50; f32 card vs an f64 NumPy HALS
   at 1000x500 rank 25 over 50 sweeps, within 1e-4 relative;
8. nmf on the gram path at 100 000x10 000 rank 200 with init='nndsvd',
   in f32 and with data_dtype='bfloat16': costs finite and
   non-increasing, the bf16 final cost within 1e-2 of the f32 one.

Then a JSON line of per-kernel results and, last, the device line.  A
kernel's ``launches`` count its launches on its path: phase 3 for the
three fused kernels, phase 6 (the only path that runs it) for
kl_phi_dot_ht_dma, each counter set to 0 just before.
Imports nothing of JAX.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import numpy as np

KERNELS = (("phi_dot_ht", "nmf_toolbox_tpu/ops/pallas/fused.py:128"),
           ("wt_dot_phi", "nmf_toolbox_tpu/ops/pallas/fused.py:218"),
           ("cost_terms", "nmf_toolbox_tpu/ops/pallas/fused.py:292"))
SOURCE = "nmf_toolbox_tpu_torch/csrc/fused.cu"
# The tensor-core kernels of SOURCE: wrapper, kernel template and the
# template arguments (TRANS) that select it in the mangled name.
TENSOR_CORE = (("phi_dot_ht", "phase_kernel", "ILb0E"),
               ("wt_dot_phi", "phase_kernel", "ILb1E"))
DMA = ("kl_phi_dot_ht_dma", "nmf_toolbox_tpu/ops/pallas/fused_dma.py:85",
       "nmf_toolbox_tpu_torch/csrc/fused_dma.cu")
CHECK_SHAPES = ((300, 700, 40), (40_000, 10_000, 100), (2_000, 3_000, 1024))
MAIN = (40_000, 10_000, 100)   # the KL shape of models/nmf.py:316-321
GRAM = (100_000, 10_000, 200)  # bench.py's headline shape
COMPARE = ((40_000, 10_000, 100), (20_000, 5_000, 100), (10_000, 10_000, 200))
# ^ benchmarks/pallas_compare.py:32
WEIGHTED = (20_000, 2_000, 50)  # weighted HALS: 2k passes over m*n per sweep
REL_TOL = 1e-4        # tests/test_pallas.py, f32 path
SOLVER_RTOL = 2e-3    # tests/test_pallas.py::test_fused_solver_matches_naive
ORACLE_RTOL = 1e-5    # bench.py objective check
HALS_ORACLE_RTOL = 1e-4  # f32 HALS vs f64 HALS objective, 50 sweeps
BF16_RTOL = 1e-2      # bf16-stored V vs f32 V, final gram-path cost
REL_DECREASE_TOL = 1e-4  # bench.py:52
TOL_CHUNK, TOL_CAP = 20, 600  # bench.py:103,133
ITERS = 10
HALS_ITERS = 20


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


def flops(name, mode, m, n, k):
    """The FLOPs a kernel's algorithm needs: V_hat (2mnk) plus one (kl) or
    two (is) contractions of 2mnk for the phases; V_hat for cost_terms."""
    if name == "cost_terms":
        return 2 * m * n * k
    return (4 if mode == "kl" else 6) * m * n * k


def tensor_core_counts(_build):
    """HMMA / HGMMA instructions per kernel function of the built library,
    from cuobjdump -sass (beside nvcc in the toolkit)."""
    cuobjdump = pathlib.Path(_build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(_build.library_path())],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split(":", 1)[1].strip()
            counts[fn] = 0
        elif fn and ("HMMA" in line or "HGMMA" in line):
            counts[fn] += 1
    return counts


def phase1_build():
    from nmf_toolbox_tpu_torch.ops.kernels import _build
    t0 = time.perf_counter()
    _build.load()
    say(f"phase 1 build: {time.perf_counter() - t0:.2f} s "
        f"({_build.library_path().name}, from {len(_build.sources())} sources)")
    counts = tensor_core_counts(_build)
    for wrapper, template, selector in TENSOR_CORE:
        mine = {fn: c for fn, c in counts.items() if template in fn and selector in fn}
        total = sum(mine.values())
        say(f"phase 1 sass {wrapper}: {total} tensor-core instructions (HMMA/HGMMA) "
            f"in {len(mine)} instantiations of {template} ({sorted(mine.values())})")
        if total == 0:
            raise AssertionError(f"{wrapper}: no HMMA or HGMMA in the library's SASS")
    # Each kernel's registers and spills, from nvcc's -Xptxas -v output.
    name = None
    for line in _build.library_path().with_suffix(".log").read_text().splitlines():
        if "Compiling entry function" in line:
            name, spills = line.split("'")[1], ""
        elif "spill stores" in line and name:
            spills = line.strip()
        elif "Used" in line and "registers" in line and name:
            short = name.split("_cu_")[-1] if "_cu_" in name else name
            say(f"phase 1 ptxas {short}: {line.split(':', 1)[1].strip()}; {spills}")
            name = None


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
                again = as_tuple(fn(V, W, H, mode))
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise AssertionError(f"{name} {mode} at {m}x{n} k={k}: "
                                         "two runs differ in their bits")
                s = stats[name]
                s["max_abs_err"] = max(s["max_abs_err"], abs_)
                s["max_rel_err"] = max(s["max_rel_err"], rel)
                line = f"phase 2 {name} {mode} {m}x{n} k={k}: rel {rel:.3g}, abs {abs_:.3g}"
                if (m, n, k) == MAIN:
                    ms = cuda_ms(torch, lambda: fn(V, W, H, mode), 5)
                    plain = cuda_ms(torch, lambda: ref(V, W, H, mode), 5)
                    suffix = "" if mode == "kl" else "_is"
                    tflops = flops(name, mode, m, n, k) / (ms * 1e-3) / 1e12
                    s["ms" + suffix], s["plain_ms" + suffix] = ms, plain
                    s["tflops" + suffix] = tflops
                    line += (f", kernel {ms:.3f} ms ({tflops:.1f} TFLOP/s), "
                             f"plain {plain:.3f} ms")
                say(line)
        del V, W, H
    return stats


def check_dma(torch, dk, V, W, H, stats, label):
    """kl_phi_dot_ht_dma against its plain version on one input."""
    got = dk.kl_phi_dot_ht_dma(V, W, H)
    torch.cuda.synchronize()
    want = dk.kl_phi_dot_ht_dma_reference(V, W, H)
    rel = rel_err(got, want)
    abs_ = float((got.double() - want.double()).abs().max())
    if not rel <= REL_TOL:
        raise AssertionError(f"kl_phi_dot_ht_dma at {label}: max relative "
                             f"error {rel:.3g} > {REL_TOL}")
    stats["max_abs_err"] = max(stats["max_abs_err"], abs_)
    stats["max_rel_err"] = max(stats["max_rel_err"], rel)
    return rel, abs_


def phase2_dma(torch, dk, main_V):
    """The streamed W-phase kernel at the check shapes it takes (k <= 512)
    and the W-phase comparison's shapes; k = 1024 must raise."""
    stats = {"max_abs_err": 0.0, "max_rel_err": 0.0}
    rng = np.random.default_rng(2)
    for (m, n, k) in ((300, 700, 40),) + COMPARE:
        V = main_V if (m, n) == MAIN[:2] else torch.from_numpy(
            rng.uniform(0.1, 1, (m, n)).astype(np.float32)).cuda()
        W = torch.from_numpy(rng.uniform(0.1, 1, (m, k)).astype(np.float32)).cuda()
        H = torch.from_numpy(rng.uniform(0.1, 1, (k, n)).astype(np.float32)).cuda()
        rel, abs_ = check_dma(torch, dk, V, W, H, stats, f"{m}x{n} k={k}")
        line = f"phase 2 kl_phi_dot_ht_dma {m}x{n} k={k}: rel {rel:.3g}, abs {abs_:.3g}"
        if (m, n, k) == MAIN:
            stats["ms"] = cuda_ms(torch, lambda: dk.kl_phi_dot_ht_dma(V, W, H), 5)
            stats["plain_ms"] = cuda_ms(
                torch, lambda: dk.kl_phi_dot_ht_dma_reference(V, W, H), 5)
            line += f", kernel {stats['ms']:.3f} ms, plain {stats['plain_ms']:.3f} ms"
        say(line)
        del V, W, H
    m, n, k = CHECK_SHAPES[2]
    try:
        dk.kl_phi_dot_ht_dma(*(torch.ones(s, device="cuda")
                               for s in ((m, n), (m, k), (k, n))))
    except ValueError as e:
        say(f"phase 2 kl_phi_dot_ht_dma {m}x{n} k={k}: ValueError ({e})")
    else:
        raise AssertionError("kl_phi_dot_ht_dma accepted k = 1024")
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


def copy_gbps(torch):
    """Device-to-device copy bandwidth, read plus write, of a 2 GiB buffer."""
    x = torch.empty(2 ** 29, dtype=torch.float32, device="cuda")
    y = torch.empty_like(x)
    ms = cuda_ms(torch, lambda: y.copy_(x), 10)
    return 2 * x.numel() * 4 / (ms * 1e-3) / 1e9


def phase6_wphase_compare(torch, fk, dk, lib, stats):
    """benchmarks/pallas_compare.py on the card: the KL W-phase op three
    ways at its three shapes, with the one-V-read floor from the copy
    bandwidth measured here.  Returns the dma kernel's launches, counted
    from 0 at the start of this phase."""
    gbps = copy_gbps(torch)
    say(f"phase 6 device-to-device copy: {gbps:.1f} GB/s (read + write)")
    dk.kl_phi_dot_ht_dma_launches = 0
    for si, (m, n, k) in enumerate(COMPARE):
        rng = np.random.default_rng(si)
        V, W, H = (torch.from_numpy(rng.uniform(0.05, 1.0, s).astype(np.float32)).cuda()
                   for s in ((m, n), (m, k), (k, n)))
        floor_ms = m * n * 4 / (gbps * 1e9) * 1e3
        check_dma(torch, dk, V, W, H, stats, f"{m}x{n} k={k} (phase 6)")
        variants = (("plain", lambda: dk.kl_phi_dot_ht_dma_reference(V, W, H)),
                    ("fused", lambda: fk.phi_dot_ht(V, W, H, "kl")),
                    ("dma", lambda: dk.kl_phi_dot_ht_dma(V, W, H)))
        for name, fn in variants:
            ms = cuda_ms(torch, fn, 10)
            row = {"variant": name, "shape": f"{m}x{n} r{k}", "ms": ms,
                   "floor_ms": floor_ms, "pct_of_floor": 100 * floor_ms / ms}
            if name == "dma":
                row["smem_bytes"] = lib.nmf_dma_smem_bytes(k)
            say(f"phase 6 {json.dumps(row)}")
        del V, W, H
    launches = dk.kl_phi_dot_ht_dma_launches
    if launches <= 0:
        raise AssertionError("the W-phase comparison never launched kl_phi_dot_ht_dma")
    return launches


def direct_cost(torch, V, W, H):
    """0.5 ||V - W H||^2 as a direct f32 residual (bench.py's measure)."""
    E = torch.addmm(V, W, H, alpha=-1.0)
    c = 0.5 * float(torch.linalg.vector_norm(E)) ** 2
    del E
    return c


def check_trace(name, res, iters, torch, monotone=True, slack=0.0):
    c = np.asarray(res.cost, np.float64)
    if res.n_iters != iters or not np.all(np.isfinite(c)):
        raise AssertionError(f"{name}: n_iters {res.n_iters}, cost {c}")
    if monotone and not np.all(np.diff(c) <= slack * np.abs(c[:-1])):
        raise AssertionError(f"{name}: cost increased: {c}")
    for f in ("W", "H"):
        x = getattr(res, f)
        if x.device.type != "cuda" or not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{name}: {f} not finite on the card")
    return c


def hals_oracle(V, W, H, sweeps, eps):
    """Literal HALS sweeps (models/hals.py:123-152) in f64 NumPy."""
    W, H = W.copy(), H.copy()
    k = W.shape[1]
    for _ in range(sweeps):
        HHt, VHt = H @ H.T, V @ H.T
        dH = np.maximum(np.diag(HHt), eps)
        for j in range(k):
            W[:, j] = np.maximum(W[:, j] + (VHt[:, j] - W @ HHt[:, j]) / dH[j], eps)
        WtW, WtV = W.T @ W, W.T @ V
        dW = np.maximum(np.diag(WtW), eps)
        for j in range(k):
            H[j] = np.maximum(H[j] + (WtV[j] - WtW[j] @ H) / dW[j], eps)
    return W, H


def phase7_hals(torch, nmf_hals, V):
    from nmf_toolbox_tpu_torch.core import EPS
    from nmf_toolbox_tpu_torch.models.hals import _sweep_rows
    from nmf_toolbox_tpu_torch.utils.init import nndsvd
    m, n, k = GRAM
    g = torch.Generator(device="cuda").manual_seed(1)
    W0 = torch.rand((m, k), generator=g, device="cuda")
    H0 = torch.rand((k, n), generator=g, device="cuda")
    kw = dict(tolerance=1e-30)
    nmf_hals(V, k, W_init=W0, H_init=H0, maxiter=2, **kw)  # warm-up
    res, ms = wall_ms(torch, lambda: nmf_hals(V, k, W_init=W0, H_init=H0,
                                              maxiter=HALS_ITERS, **kw))
    c = check_trace("hals", res, HALS_ITERS, torch, slack=0.0)
    # The sweeps alone (2k in-place row updates) against one iteration.
    Wt, H = res.W.T.contiguous(), res.H.clone()
    HHt, VHt_t, WtW, WtV = H @ H.T, H @ V.T, Wt @ Wt.T, Wt @ V
    dH = torch.clamp_min(torch.diagonal(HHt), EPS)
    dW = torch.clamp_min(torch.diagonal(WtW), EPS)
    sweeps_ms = cuda_ms(torch, lambda: (_sweep_rows(Wt, HHt.T, VHt_t, dH, EPS),
                                        _sweep_rows(H, WtW, WtV, dW, EPS)), 3)
    gemm_ms = cuda_ms(torch, lambda: (H @ V.T, Wt @ V), 3)
    del Wt, H, HHt, VHt_t, WtW, WtV
    say(f"phase 7 hals {m}x{n} r{k}: {ms / HALS_ITERS:.2f} ms/iter; sweeps "
        f"{sweeps_ms:.2f} ms ({100 * sweeps_ms * HALS_ITERS / ms:.1f}% of an "
        f"iteration), the two V products {gemm_ms:.2f} ms; final cost {c[-1]:.7g}")
    res_x, ms_x = wall_ms(torch, lambda: nmf_hals(
        V, k, W_init=W0, H_init=H0, maxiter=HALS_ITERS, extrapolate=True, **kw))
    cx = check_trace("hals extrapolate", res_x, HALS_ITERS, torch, monotone=False)
    true_x, true_p = (direct_cost(torch, V, r.W, r.H) for r in (res_x, res))
    say(f"phase 7 hals extrapolate: {ms_x / HALS_ITERS:.2f} ms/iter; objective "
        f"after {HALS_ITERS} sweeps {true_x:.7g} (plain {true_p:.7g}); "
        f"surrogate trace ends {cx[-1]:.7g}")
    del res, res_x

    def run_to_tol(W, H, seeded):
        """bench.py:121-142: chunks of TOL_CHUNK sweeps until the direct
        cost's relative decrease per chunk is below REL_DECREASE_TOL per
        iteration, at most TOL_CAP iterations; seeding inside the clock."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if seeded:
            W, H = nndsvd(V, k, generator=torch.Generator(device="cuda").manual_seed(2))
        c_prev, iters = None, 0
        while iters < TOL_CAP:
            r = nmf_hals(V, k, W_init=W, H_init=H, maxiter=TOL_CHUNK, **kw)
            W, H = r.W, r.H
            iters += TOL_CHUNK
            c = direct_cost(torch, V, W, H)
            if c_prev is not None and (c_prev - c) / c < REL_DECREASE_TOL * TOL_CHUNK:
                break
            c_prev = c
        torch.cuda.synchronize()
        if not (np.isfinite(c) and bool(torch.isfinite(W).all())):
            raise AssertionError(f"time-to-tolerance run ended at cost {c}")
        return time.perf_counter() - t0, iters, c

    nndsvd(V, k, generator=torch.Generator(device="cuda").manual_seed(9))  # warm-up
    for label, seeded in (("random", False), ("nndsvd", True)):
        dt, iters, c = run_to_tol(W0, H0, seeded)
        v_sq = float(torch.linalg.vector_norm(V)) ** 2
        say(f"phase 7 hals time-to-tolerance ({label} init): {dt:.3f} s over "
            f"{iters} iterations (cap {TOL_CAP}), rel recon err "
            f"{(2 * c / v_sq) ** 0.5:.5f}")
    del W0, H0

    m2, n2, k2 = WEIGHTED
    g2 = torch.Generator(device="cuda").manual_seed(3)
    V2 = 0.05 + 0.95 * torch.rand((m2, n2), generator=g2, device="cuda")
    M = (torch.rand((m2, n2), generator=g2, device="cuda") < 0.7).float()
    res_w, ms_w = wall_ms(torch, lambda: nmf_hals(V2, k2, weights=M, maxiter=5,
                                                  seed=4, **kw))
    # f32 rounding of the carried residual: allow 1e-6 relative per sweep
    cw = check_trace("weighted hals", res_w, 5, torch, slack=1e-6)
    say(f"phase 7 weighted hals {m2}x{n2} r{k2}, 70% weights: {ms_w / 5:.2f} "
        f"ms/iter, cost {cw[0]:.7g} -> {cw[-1]:.7g}")
    del V2, M, res_w

    rng = np.random.default_rng(42)
    Vo = rng.uniform(0.05, 1.0, (1000, 500))
    Wo, Ho = rng.uniform(size=(1000, 25)), rng.uniform(size=(25, 500))
    Wf, Hf = hals_oracle(Vo, Wo, Ho, 50, EPS)
    c_oracle = 0.5 * np.sum((Vo - Wf @ Hf) ** 2)
    r = nmf_hals(Vo.astype(np.float32), 25, W_init=Wo.astype(np.float32),
                 H_init=Ho.astype(np.float32), maxiter=50, device="cuda", **kw)
    Wc, Hc = (x.cpu().numpy().astype(np.float64) for x in (r.W, r.H))
    rel = abs(0.5 * np.sum((Vo - Wc @ Hc) ** 2) - c_oracle) / c_oracle
    if not rel <= HALS_ORACLE_RTOL:
        raise AssertionError(f"hals objective {rel:.3g} from the f64 oracle "
                             f"> {HALS_ORACLE_RTOL}")
    say(f"phase 7 hals objective check 1000x500 r25, 50 sweeps: {rel:.3g} "
        "relative to the f64 NumPy HALS")


def phase8_nmf_options(torch, nmf, V):
    k = GRAM[2]
    kw = dict(init="nndsvd", maxiter=ITERS, tolerance=1e-30)
    final = {}
    for label, extra in (("f32", {}), ("bf16", {"data_dtype": "bfloat16"})):
        nmf(V, k, **{**kw, **extra, "maxiter": 2})  # warm-up
        r, ms = wall_ms(torch, lambda: nmf(V, k, **kw, **extra))
        c = check_trace(f"nmf nndsvd {label}", r, ITERS, torch)
        final[label] = c[-1]
        say(f"phase 8 nmf gram init='nndsvd' {label} data {GRAM[0]}x{GRAM[1]} "
            f"r{k}: {ms / ITERS:.2f} ms/iter (seeding included), cost "
            f"{c[0]:.7g} -> {c[-1]:.7g}")
    rel = abs(final["bf16"] - final["f32"]) / final["f32"]
    if not rel <= BF16_RTOL:
        raise AssertionError(f"bf16 final cost {rel:.3g} from f32 > {BF16_RTOL}")
    say(f"phase 8 bf16 vs f32 final cost: {rel:.3g} relative")


def main():
    import torch
    phase0_device(torch)
    phase1_build()
    from nmf_toolbox_tpu_torch import nmf, nmf_hals
    from nmf_toolbox_tpu_torch.ops.kernels import _build
    from nmf_toolbox_tpu_torch.ops.kernels import fused as fk
    from nmf_toolbox_tpu_torch.ops.kernels import fused_dma as dk

    m, n, k = MAIN
    rng = np.random.default_rng(0)
    V = torch.from_numpy(rng.uniform(0.1, 1, (m, n)).astype(np.float32)).cuda()
    W0 = rng.uniform(size=(m, k)).astype(np.float32)
    H0 = rng.uniform(size=(k, n)).astype(np.float32)

    stats = phase2_kernels(torch, fk, V)
    dma_stats = phase2_dma(torch, dk, V)
    main_path = phase3_main_path(torch, fk, nmf, V, W0, H0)
    del V
    torch.cuda.empty_cache()
    phase4_gram(torch, nmf)
    phase5_objective(torch, nmf)
    dma_launches = phase6_wphase_compare(torch, fk, dk, _build.load(), dma_stats)
    torch.cuda.empty_cache()
    m, n, k = GRAM
    g = torch.Generator(device="cuda").manual_seed(0)
    V = 0.05 + 0.95 * torch.rand((m, n), generator=g, device="cuda")
    phase7_hals(torch, nmf_hals, V)
    phase8_nmf_options(torch, nmf, V)
    del V

    kernels = []
    for name, replaces in KERNELS:
        s = stats[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
            "launches": sum(main_path[d]["launches"][name] for d in ("kl", "is")),
            "max_abs_err": s["max_abs_err"], "max_rel_err": s["max_rel_err"],
            "ms": s["ms"], "plain_ms": s["plain_ms"],
            "ms_is": s["ms_is"], "plain_ms_is": s["plain_ms_is"],
            "tflops": s["tflops"], "tflops_is": s["tflops_is"],
        })
    name, replaces, source = DMA
    kernels.append({
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": dma_launches, "max_abs_err": dma_stats["max_abs_err"],
        "max_rel_err": dma_stats["max_rel_err"], "ms": dma_stats["ms"],
        "plain_ms": dma_stats["plain_ms"],
    })
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
