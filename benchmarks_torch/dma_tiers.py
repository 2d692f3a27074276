#!/usr/bin/env python3
"""Time kl_phi_dot_ht_dma's tier table against other tier tables on the card.

    python benchmarks_torch/dma_tiers.py

Builds, beside this checkout's kernels, one library of
``csrc/fused_dma.cu`` for each of VARIANTS: a source that defines the
variant's ``NMF_DMA_TIERS`` (``tier<MAXK, RW, CW, NKW>()`` entries) and
includes ``fused_dma.cu``, with nvcc's registers and spills.  At each of
SHAPES (inputs uniform(0.05, 1), as chip_smoke.py's phase 6 makes them)
it times the built-in kernel and every variant in two rounds, in turns,
by ``chip_smoke.cuda_ms`` (10 launches after a warm-up), with each
variant's max relative error against the built-in kernel and the tier
that ran, and prints one JSON line per shape with the card's name and
power limit.  The plain composition and ``phi_dot_ht`` at these shapes
are timed by chip_smoke.py's phase 6 and ``turns.py``.
Needs a CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import shutil
import subprocess
import sys

import numpy as np

HERE = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
import chip_smoke as cs  # noqa: E402

K128 = "tier<128, 4, 1, 16>()"
K256 = "tier<256, 3, 2, 16>()"
TOP = "tier<424, 3, 4, 16>(), tier<MAX_K, 2, 4, 16>()"
VARIANTS = {
    # k <= 64 on a tier of its own with 8 output subtiles a warp, not 16.
    "k64_tier": f"tier<64, 4, 1, 8>(), {K128}, {K256}, {TOP}",
    # k <= 256 on 64-row blocks of 8 warps in 2 column groups.
    "rows64_k256": f"{K128}, tier<256, 4, 2, 16>(), {TOP}",
    # k <= 256 on 32-row blocks of 4 warps in 2 column groups.
    "rows32_cw2_k256": f"{K128}, tier<256, 2, 2, 16>(), {TOP}",
    # k <= 256 on 32-row blocks of 8 warps in 4 column groups.
    "rows32_cw4_k256": f"{K128}, tier<256, 2, 4, 8>(), {TOP}",
    # 257 <= k <= 424 on 32-row blocks, as k <= 512.
    "rows32_k424": f"{K128}, {K256}, tier<MAX_K, 2, 4, 16>()",
}
SHAPES = ((40_000, 10_000, 64),) + cs.COMPARE + ((10_000, 10_000, 300),)


def build_variant(_build, name, tiers, out_dir):
    """Start nvcc on the dma library with the variant's tier table."""
    d = out_dir / name
    d.mkdir(parents=True)
    src = d / "variant.cu"
    src.write_text(f"#define NMF_DMA_TIERS {tiers}\n#include \"fused_dma.cu\"\n")
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-shared",
           "-o", str(d / "lib.so"), str(src)]
    return d / "lib.so", subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True)


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("dma_tiers: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    from nmf_toolbox_tpu_torch.ops.kernels import _build
    from nmf_toolbox_tpu_torch.ops.kernels import fused_dma as dk
    out_dir = _build.BUILD_DIR / "dma_tiers"
    shutil.rmtree(out_dir, ignore_errors=True)
    builds = {name: build_variant(_build, name, tiers, out_dir)
              for name, tiers in VARIANTS.items()}
    libs = {"built_in": _build.load()}
    for name, (path, proc) in builds.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name} failed to build:\n{text}")
        ptxas = [line.strip() for line in text.splitlines()
                 if "registers" in line or "spill" in line]
        print(json.dumps({"variant": name, "tiers": VARIANTS[name], "ptxas": ptxas}), flush=True)
        libs[name] = _build.bind(ctypes.CDLL(str(path)))

    def dma(lib, V, W, H):
        (m, n), k = V.shape, W.shape[1]
        out = torch.empty((m, k), device=V.device)
        err = lib.nmf_kl_phi_dot_ht_dma(V.data_ptr(), W.data_ptr(), H.data_ptr(),
                                        out.data_ptr(), m, n, k,
                                        torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed at {m}x{n} k={k}: error {err}")
        return out

    card = cs.card()
    for si, (m, n, k) in enumerate(SHAPES):
        g = np.random.default_rng(si)
        V, W, H = (torch.from_numpy(g.uniform(0.05, 1.0, s).astype(np.float32)).cuda()
                   for s in ((m, n), (m, k), (k, n)))
        want = dk.kl_phi_dot_ht_dma(V, W, H)
        row = {"card": card, "shape": f"{m}x{n} r{k}"}
        for name, lib in libs.items():
            if lib.nmf_dma_smem_bytes(k) > 232448:
                row[name] = "does not fit"
                continue
            row[name] = {"ms": [], "tier": cs.dma_tier(lib, k),
                         "max_rel_err": cs.rel_err(dma(lib, V, W, H), want)}
        for _ in range(2):
            for name, lib in libs.items():
                if isinstance(row[name], dict):
                    row[name]["ms"].append(cs.cuda_ms(torch, lambda: dma(lib, V, W, H), 10))
        print(json.dumps(row), flush=True)
        del V, W, H, want


if __name__ == "__main__":
    main()
