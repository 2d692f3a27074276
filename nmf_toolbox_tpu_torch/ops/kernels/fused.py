"""Fused KL / IS kernels for the multiplicative updates.

PyTorch counterpart of ``nmf_toolbox_tpu/ops/pallas/fused.py``.  The KL
and IS gradient fields are nonlinear in the reconstruction
(Phi = V / (W H), V / (W H)^2, 1 / (W H) — nmf.m:151-156), so unlike the
Euclidean Gram path the m-by-n reconstruction is required.  These
kernels keep it out of device memory: each block rebuilds V_hat tiles on
the chip from W and H, applies the field and contracts it in the same
pass.  The CUDA source is ``csrc/fused.cu``.

Each wrapper takes the JAX signature ``(V, W, H, mode)`` with ``mode`` in
{"kl", "is"} and f32 row-major ``V (m, n)``, ``W (m, k)``, ``H (k, n)``,
``1 <= k <= 1024``.  Tensors on the CPU go to the plain PyTorch version
beside it (``*_reference``); tensors on a CUDA device launch the kernel
on the current stream, or raise.  Nothing falls back.  Each launch adds
one to the wrapper's counter (``phi_dot_ht_launches`` and so on).
"""
from __future__ import annotations

import torch

from . import _build

MAX_K = 1024
MODES = ("kl", "is")

phi_dot_ht_launches = 0
wt_dot_phi_launches = 0
cost_terms_launches = 0


def _on_cpu(V, W, H, mode, max_k=MAX_K) -> bool:
    """Validate the operands; True for CPU tensors, False for CUDA ones."""
    if mode not in MODES:
        raise ValueError(f"mode must be 'kl' or 'is', got {mode!r}")
    for name, x in (("V", V), ("W", W), ("H", H)):
        if not torch.is_tensor(x) or x.ndim != 2 or x.dtype != torch.float32:
            raise TypeError(f"{name} must be a 2-D float32 tensor")
    m, n = V.shape
    k = W.shape[1]
    if W.shape[0] != m or tuple(H.shape) != (k, n):
        raise ValueError(f"shapes V {tuple(V.shape)}, W {tuple(W.shape)}, "
                         f"H {tuple(H.shape)} do not form V ~ W @ H")
    if m < 1 or n < 1 or not 1 <= k <= max_k:
        raise ValueError(f"need m, n >= 1 and 1 <= k <= {max_k}; "
                         f"got m={m}, n={n}, k={k}")
    if not V.device == W.device == H.device:
        raise ValueError("V, W and H must lie on one device")
    if V.device.type == "cpu":
        return True
    if V.device.type != "cuda":
        raise ValueError(f"no kernel for device {V.device}")
    if not (V.is_contiguous() and W.is_contiguous() and H.is_contiguous()):
        raise ValueError("V, W and H must be contiguous")
    return False


def _phase(fn_name, phase, V, W, H, mode, shape):
    """Launch a W- or H-phase kernel: one (kl) or two (is) outputs of
    ``shape``, plus the span scratch the library asks for."""
    lib = _build.load()
    m, n = V.shape
    k = W.shape[1]
    dev = V.device
    a = torch.empty(shape, dtype=torch.float32, device=dev)
    b = torch.empty(shape, dtype=torch.float32, device=dev) if mode == "is" else None
    with torch.cuda.device(dev):
        size = lib.nmf_phase_scratch(phase, m, n, k, MODES.index(mode))
        part = torch.empty((size,), dtype=torch.float32, device=dev) if size else None
        err = getattr(lib, fn_name)(
            V.data_ptr(), W.data_ptr(), H.data_ptr(), a.data_ptr(),
            0 if b is None else b.data_ptr(), 0 if part is None else part.data_ptr(),
            m, n, k, MODES.index(mode), torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, fn_name, err)
    return a if b is None else (a, b)


def _raise_on(lib, fn_name, err):
    if err != 0:
        raise RuntimeError(f"{fn_name} failed: CUDA error {err} "
                           f"({lib.nmf_error_string(err).decode()})")


# ---------------------------------------------------------------------------
# W-phase: Phi @ H'
#
# Replaces: nmf_toolbox_tpu/ops/pallas/fused.py phi_dot_ht (_w_phase_kernel),
#   called every iteration by the fused W update (models/nmf.py:206,213).
# Bound on the H100: arithmetic.  It does 4mnk FLOPs (kl; 6mnk for is: V_hat
#   and one or two contractions) against one 4mn-byte read of V, about
#   100 FLOP/byte at k = 100, so the tensor cores and the latency of the
#   mma chains that feed them bound it, not HBM.  Registers (the (m, k)
#   accumulators) cap it at 2-3 blocks of 4 warps per SM.
# Design: two chained GEMMs per tile, shaped like FlashAttention's forward
#   pass, on TF32 tensor cores (mma.sync m16n8k8) in 3xTF32: each f32
#   operand is split into hi = tf32(x) and lo = tf32(x - hi) and a product
#   is lo*hi + hi*lo + hi*hi with f32 accumulation, which keeps the f32
#   plain version's accuracy.  A block owns 64 rows of the output (16 per
#   warp) and loops over n, so the reduction over n stays inside the block
#   (the Pallas kernel's sequential grid axis has no GPU equivalent).  Per
#   n-tile (24 columns for kl, 32 for is) a warp builds its V_hat fragment,
#   forms the field from the f32 accumulator and feeds it to the second
#   product from registers, with n permuted inside each group of 8 so that
#   the accumulator layout is the operand layout.  The tile's products go
#   to zeroed fragments and reach the running output through one rounded
#   f32 add per tile, as the tensor cores truncate while they accumulate.
#   Tiles of W, H and V stream through a two-stage cp.async ring; each H
#   tile is split into hi and lo once, in shared memory, for all warps.
#   Where 64-row blocks are too few to fill the card, n is cut into spans
#   over the grid, chosen from the kernel's occupancy, each writing a
#   partial output that a second kernel adds in span order
#   (deterministic).  k is padded to 8 and cut into output chunks of at
#   most 128 over the grid; k > 128 rebuilds V_hat once per chunk.
# ---------------------------------------------------------------------------

def phi_dot_ht_reference(V, W, H, mode: str = "kl"):
    """Plain PyTorch version of :func:`phi_dot_ht`."""
    V_hat = W @ H
    if mode == "kl":
        return (V / V_hat) @ H.T
    return (V / (V_hat * V_hat)) @ H.T, (1.0 / V_hat) @ H.T


def phi_dot_ht(V, W, H, mode: str = "kl"):
    """Phi(V, W@H) @ H' without materializing W@H or Phi.

    mode='kl' returns one (m, k) tensor ((V / V_hat) @ H', nmf.m:152);
    mode='is' returns two ((V / V_hat^2) @ H', (1 / V_hat) @ H',
    nmf.m:155-156).
    """
    global phi_dot_ht_launches
    if _on_cpu(V, W, H, mode):
        return phi_dot_ht_reference(V, W, H, mode)
    out = _phase("nmf_phi_dot_ht", 0, V, W, H, mode, (V.shape[0], W.shape[1]))
    phi_dot_ht_launches += 1
    return out


# ---------------------------------------------------------------------------
# H-phase: W' @ Phi
#
# Replaces: nmf_toolbox_tpu/ops/pallas/fused.py wt_dot_phi (_h_phase_kernel),
#   called every iteration by the fused H update (models/nmf.py:223,226).
# Bound on the H100: arithmetic, as the W-phase (same FLOPs and bytes).
#   Its output alone gives few blocks (157 at n = 10 000 for 132 SMs), so
#   filling the card is part of the problem.
# Design: the W-phase of the transposed problem,
#   wt_dot_phi(V, W, H) = phi_dot_ht(V', H', W')', run by the same kernel
#   body: it reads its tiles of V, W and H through transposing accessors
#   and writes the (k, n) output transposed.  A block owns 64 columns of
#   the output and loops over m, cut into spans over the grid (partial
#   outputs added in span order).
# ---------------------------------------------------------------------------

def wt_dot_phi_reference(V, W, H, mode: str = "kl"):
    """Plain PyTorch version of :func:`wt_dot_phi`."""
    V_hat = W @ H
    if mode == "kl":
        return W.T @ (V / V_hat)
    return W.T @ (V / (V_hat * V_hat)), W.T @ (1.0 / V_hat)


def wt_dot_phi(V, W, H, mode: str = "kl"):
    """W' @ Phi(V, W@H) without materializing W@H or Phi.

    mode='kl' returns (k, n) W'(V / V_hat) (nmf.m:183); mode='is' returns
    (W'(V / V_hat^2), W'(1 / V_hat)) (nmf.m:186-187).
    """
    global wt_dot_phi_launches
    if _on_cpu(V, W, H, mode):
        return wt_dot_phi_reference(V, W, H, mode)
    out = _phase("nmf_wt_dot_phi", 1, V, W, H, mode, (W.shape[1], V.shape[1]))
    wt_dot_phi_launches += 1
    return out


# ---------------------------------------------------------------------------
# Cost terms
#
# Replaces: nmf_toolbox_tpu/ops/pallas/fused.py cost_terms (_cost_kernel),
#   called on check iterations by the fused objective (models/nmf.py:231,235),
#   so once per iteration at the default cost_every=1.
# Bound on the H100: compute and memory tie.  V_hat takes 2mnk FLOPs,
#   which f32-accurate tensor-core work (3xTF32: 495 / 3 = 165 TFLOP/s)
#   does in 0.49 ms at 40 000x10 000 k=100, and the one read of V (1.6 GB
#   at 3.35 TB/s) takes 0.48 ms.  The 4e8 accurate logs are left out of
#   the bound; where they do not run under the products they cost ~0.8 ms
#   (PERF.md §6).
# Design: one GEMM tile per block with a reducing epilogue, no (m, k)
#   accumulator and so no FlashAttention chain.  A block of 8 warps builds
#   a 128x128 tile of V_hat on TF32 tensor cores (mma.sync m16n8k8) in
#   3xTF32, as the phase kernels do; each warp holds 64x32 outputs, so
#   every k-step issues 16 independent mma chains, and two blocks share an
#   SM.  k streams in slabs of 32 through a two-stage cp.async ring (padded
#   with zeros to the slab); each warp splits the operands it reads into hi
#   and lo as they leave shared memory.  The V tile then comes into the
#   ring by cp.async; the epilogue forms the f32 terms in registers with
#   the accurate logf, masks the ragged edges and sums in a fixed order:
#   f32 per row of a thread, f64 over its rows, the warp by a fixed
#   butterfly and the block in warp order, one partial per block.  A
#   one-block kernel adds the partials in a fixed order, so repeated runs
#   give identical bits; no atomics.
# ---------------------------------------------------------------------------

def cost_terms_reference(V, W, H, mode: str = "kl"):
    """Plain PyTorch version of :func:`cost_terms`."""
    V_hat = W @ H
    if mode == "kl":
        return torch.sum(V * torch.log(V_hat))
    return torch.sum(torch.log(V_hat)), torch.sum(V / V_hat)


def cost_terms(V, W, H, mode: str = "kl"):
    """Scalar field-dependent cost pieces, fused over tiles.

    mode='kl': returns sum(V * log(W@H)).
    mode='is': returns (sum(log(W@H)), sum(V / (W@H))).
    Each is a 0-d f32 tensor on V's device.
    """
    global cost_terms_launches
    if _on_cpu(V, W, H, mode):
        return cost_terms_reference(V, W, H, mode)
    lib = _build.load()
    m, n = V.shape
    part = torch.empty((2 * lib.nmf_cost_partials(m, n),), dtype=torch.float64,
                       device=V.device)
    out = torch.empty((2,), dtype=torch.float32, device=V.device)
    with torch.cuda.device(V.device):
        err = lib.nmf_cost_terms(
            V.data_ptr(), W.data_ptr(), H.data_ptr(), part.data_ptr(),
            out.data_ptr(), m, n, W.shape[1], MODES.index(mode),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, "nmf_cost_terms", err)
    cost_terms_launches += 1
    return out[0] if mode == "kl" else (out[0], out[1])
