#!/usr/bin/env python3
"""Time the Hoyer projection kernel's tier table against other tables on the card.

    python benchmarks_torch/hoyer_tiers.py [--rounds 2]

Builds, beside this checkout's kernels, one library of ``csrc/hoyer.cu``
for each of VARIANTS: a source that defines the variant's
``NMF_HOYER_TIERS_F32`` / ``_F64`` (``X(threads, entries per thread,
CTAs at most)``), includes ``hoyer.cu`` and adds ``probe_resident``,
which reads from the occupancy API how many vectors of length N the
card holds at once (clusters for a cluster tier, CTAs for one-CTA
tiers), with nvcc's registers and spills.  At each of SHAPES
(inputs as chip_smoke.py phase 18 makes them, 48 passes allowed) it
times the built-in kernel and every variant, f32 and f64, in turns for
``--rounds`` rounds: the device µs a launch from ``torch.profiler`` (the
projection kernel's own time, the mean over the launches it saw of 10:
``chip_smoke.kernel_device_ms``), each variant's done flags and pass
counts against the built-in kernel's, its max error of the largest
entry, its tier and vectors resident.  For W's columns (rows of a
strided W.mT view) it times the wrapper's design, a contiguous copy and
the kernel (CUDA events, copy included), beside the design left: the
built-in tables with the register tiers reading and writing each
column in place at W.mT's entry stride (``in_place``: ``hoyer.cu``
with its loads and stores rewritten, called through its C interface;
its v against the wrapper's, its device µs from CUDA events queued
behind a device sleep, ``chip_smoke.queued_device_ms``).

Prints one JSON line per variant's build and one per shape and dtype,
with the card's name and power limit.  Needs a CUDA card; imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import shutil
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
import chip_smoke as cs  # noqa: E402

SHORT = "X(128, 8, 1) X(256, 8, 1) X(512, 16, 1) X(1024, 16, 1)"
VARIANTS = {  # name: (f32 table, f64 table); None: csrc/hoyer.cu's own
    "built_in": (None, None),
    # long vectors on 256-thread CTAs of 64 entries (f32), 128 of 64 (f64)
    "items64": (f"{SHORT} X(256, 64, 16)", f"{SHORT} X(128, 64, 16)"),
    # long vectors on 1024-thread CTAs, 32 (f32) or 16 (f64) entries a thread
    "threads1024": (f"{SHORT} X(1024, 32, 8)", f"{SHORT} X(1024, 16, 16)"),
    # long vectors on 128-thread CTAs of 64 entries (f32), 256 of 32 (f64)
    "threads128": (f"{SHORT} X(128, 64, 16)", f"{SHORT} X(256, 32, 16)"),
    # short vectors on fewer threads with more entries each
    "short128": ("X(128, 16, 1) X(256, 16, 1) X(512, 16, 1) X(1024, 16, 1) X(256, 64, 16)",
                 "X(128, 16, 1) X(256, 16, 1) X(512, 16, 1) X(1024, 16, 1) X(512, 32, 16)"),
}
PROBE = r'''
namespace {
template <typename T, int TH, int IT, int CL>
int resident(int N) {
  auto kernel = hoyer_tile_kernel<T, TH, IT, CL>;
  const int ranks = ranks_for(N, TH * IT);
  const size_t smem = Reducer<T, TH, CL>::SCRATCH * sizeof(T);
  if (CL == 1) {
    int blocks = 0, sms = 0, dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, TH, smem);
    return blocks * sms;
  }
  if (CL > 8) cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranks * 1024);
  cfg.blockDim = dim3(TH);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = -1;
  cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  return clusters;
}
}  // namespace
#define NMF_HOYER_PROBE(TH, IT, CL) \
  if (N <= (long long)(TH) * (IT) * (CL)) return resident<T, TH, IT, CL>(N);
template <typename T> int probe(int N);
template <> int probe<float>(int N) { using T = float; NMF_HOYER_TIERS_F32(NMF_HOYER_PROBE) return 0; }
template <> int probe<double>(int N) { using T = double; NMF_HOYER_TIERS_F64(NMF_HOYER_PROBE) return 0; }
extern "C" int probe_resident(int N, int is_double) {
  return is_double ? probe<double>(N) : probe<float>(N);
}
'''
SHAPES = (("H rows", (50, 2000), False, 0.6), ("H rows", (200, 10_000), False, 0.6),
          ("batched round", (8, 50, 2000), False, 0.6),
          ("W columns", (200, 100_000), True, 0.5))
IN_PLACE_STRIDE = 200  # W.mT's entry stride at SHAPES' W columns (W is 100 000 x 200)
# The design left: hoyer.cu's register tiers with each entry at
# IN_PLACE_STRIDE elements from the last (the streaming tier unchanged).
IN_PLACE = (("const T* sp = s + first;",
             "const T* sp = s + (long long)first * IN_PLACE_STRIDE;"),
            ("sp[j * THREADS]", "sp[(long long)j * THREADS * IN_PLACE_STRIDE]"),
            ("T* op = out + first;", "T* op = out + (long long)first * IN_PLACE_STRIDE;"),
            ("op[j * THREADS]", "op[(long long)j * THREADS * IN_PLACE_STRIDE]"))


def in_place_source(csrc):
    """hoyer.cu with the loads and stores of IN_PLACE."""
    text = (csrc / "hoyer.cu").read_text()
    for old, new in IN_PLACE:
        if text.count(old) != 1:
            raise RuntimeError(f"hoyer.cu has {text.count(old)} of {old!r}, not 1")
        text = text.replace(old, new)
    return f"#define IN_PLACE_STRIDE {IN_PLACE_STRIDE}\n{text}"


def build_variant(_build, name, variant, out_dir):
    """Start nvcc on hoyer.cu with the variant's tables (``variant``:
    the two tables, or ``"in_place"``) and the probe."""
    d = out_dir / name
    d.mkdir(parents=True)
    src = d / "variant.cu"
    if variant == "in_place":
        body = in_place_source(_build.CSRC)
    else:
        f32, f64 = variant
        body = "" if f32 is None else (f"#define NMF_HOYER_TIERS_F32(X) {f32}\n"
                                       f"#define NMF_HOYER_TIERS_F64(X) {f64}\n")
        body += "#include \"hoyer.cu\"\n"
    src.write_text(body + PROBE)
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-shared",
           "-o", str(d / "lib.so"), str(src)]
    return d / "lib.so", subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True)


def in_place(torch, lib, S, k1):
    """The in-place build on S, a (B, N) view of W.mT (batch stride 1,
    entry stride IN_PLACE_STRIDE): (v, done, iters), v in S's layout."""
    B, N = S.shape
    if S.stride() != (1, IN_PLACE_STRIDE):
        raise ValueError(f"the in-place build reads strides (1, {IN_PLACE_STRIDE}), not "
                         f"{S.stride()}")
    v = torch.empty_like(S)
    done = torch.empty(B, dtype=torch.bool, device=S.device)
    iters = torch.empty(B, dtype=torch.int32, device=S.device)
    err = lib.nmf_hoyer_project(S.data_ptr(), v.data_ptr(), done.data_ptr(), iters.data_ptr(),
                                B, B, N, N, 0, 1, 0, v.stride(0), None, 0, k1, None, 0, 1.0,
                                48, int(S.dtype == torch.float64),
                                torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"the in-place build failed: CUDA error {err}")
    return v, done, iters


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("hoyer_tiers: no CUDA card")
    from nmf_toolbox_tpu_torch.ops.kernels import _build
    from nmf_toolbox_tpu_torch.ops.kernels import hoyer as hk
    from nmf_toolbox_tpu_torch.ops.projection import hoyer_l1_target
    out_dir = _build.build_dir() / "hoyer_tiers"
    shutil.rmtree(out_dir, ignore_errors=True)
    builds = {name: build_variant(_build, name, v, out_dir)
              for name, v in {**VARIANTS, "in_place": "in_place"}.items()}
    libs = {}
    for name, (path, proc) in builds.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name} failed to build:\n{text}")
        spills = sorted({line.split(":", 1)[-1].strip() for line in text.splitlines()
                         if "spill" in line})
        print(json.dumps({"variant": name, "tables": VARIANTS.get(name, name),
                          "spills": spills}), flush=True)
        libs[name] = _build.bind(ctypes.CDLL(str(path)))
        libs[name].probe_resident.argtypes = [ctypes.c_int, ctypes.c_int]
    in_place_lib = libs.pop("in_place")

    def run(lib, S, k1):
        hk._lib = lib
        return hk.hoyer_project(S, k1, 1.0, 48)

    card = cs.card()
    for i, (label, shape, transposed, sp) in enumerate(SHAPES):
        k1 = hoyer_l1_target(shape[-1], sp)
        for dtype in (torch.float32, torch.float64):
            S = cs.hoyer_input(torch, shape, transposed, dtype, 180 + i)
            want_v, want_done, want_iters = run(libs["built_in"], S, k1)
            row = {"card": card, "case": f"{label} {'x'.join(map(str, shape))} "
                   f"{str(dtype).split('.')[-1]}"}
            for name, lib in libs.items():
                v, done, iters = run(lib, S, k1)
                info = (ctypes.c_int * 3)()
                lib.nmf_hoyer_tier(shape[-1], int(dtype == torch.float64), info)
                row[name] = {
                    "device_us": [], "tier": list(info),
                    "resident": lib.probe_resident(shape[-1], int(dtype == torch.float64)),
                    "agrees": bool(torch.equal(done, want_done))
                    and int((iters - want_iters).abs().max()) <= 1,
                    "max_rel_err": float((v - want_v).abs().max() / want_v.abs().max())}
            for _ in range(args.rounds):
                for name, lib in libs.items():
                    own = cs.kernel_device_ms(torch, lambda: run(lib, S, k1), 10)[1]
                    row[name]["device_us"].append(None if own is None else 1e3 * own)
            hk._lib = libs["built_in"]
            if transposed:  # the wrapper's copy design against reading in place
                row["wrapper_copy_and_kernel_ms"] = cs.cuda_ms(
                    torch, lambda: hk.hoyer_project(S, k1, 1.0, 48), 10)
                row["copy_ms"] = cs.cuda_ms(torch, lambda: S.contiguous(), 10)
                read = (lambda: in_place(torch, in_place_lib, S, k1))  # noqa: E731
                v, done, _ = read()
                row["in_place_agrees"] = bool(torch.equal(done, want_done)) and float(
                    (v - want_v).abs().max() / want_v.abs().max()) <= 1e-4
                row["in_place_strided_ms"] = cs.cuda_ms(torch, read, 10)
                row["in_place_device_us"] = 1e3 * cs.queued_device_ms(torch, read, 10)
            print(json.dumps(row), flush=True)
            del S, want_v


if __name__ == "__main__":
    main()
