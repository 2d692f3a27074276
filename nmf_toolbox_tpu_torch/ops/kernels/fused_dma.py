"""Streamed KL W-phase kernel: (V / (W @ H)) @ H'.

PyTorch counterpart of ``nmf_toolbox_tpu/ops/pallas/fused_dma.py``, the
manually double-buffered variant of the fused W-phase
(:func:`~nmf_toolbox_tpu_torch.ops.kernels.fused.phi_dot_ht` in KL
mode).  No solver calls it: ``nmf(method="fused")`` keeps ``phi_dot_ht``
as its W-phase, as the JAX package does, and the W-phase comparison of
``chip_smoke.py`` times the two kernels against the plain composition.
The CUDA source is ``csrc/fused_dma.cu``.

``kl_phi_dot_ht_dma(V, W, H)`` takes f32 row-major ``V (m, n)``,
``W (m, k)``, ``H (k, n)`` with ``1 <= k <= 512`` (the Pallas kernel's
scope; ``ValueError`` beyond) and returns the (m, k) f32 result.
Tensors on the CPU go to the plain PyTorch version beside it
(:func:`kl_phi_dot_ht_dma_reference`); tensors on a CUDA device launch
the kernel on the current stream, or raise.  Nothing falls back.  Each
launch adds one to ``kl_phi_dot_ht_dma_launches``.
"""
from __future__ import annotations

import torch

from . import _build
from .fused import _on_cpu, _raise_on

MAX_K = 512

kl_phi_dot_ht_dma_launches = 0


# ---------------------------------------------------------------------------
# Replaces: nmf_toolbox_tpu/ops/pallas/fused_dma.py kl_phi_dot_ht_dma
#   (_kernel), reached only through the W-phase comparison
#   (benchmarks/pallas_compare.py --variant dma) and its test.
# Bound on the H100: arithmetic, as phi_dot_ht: 4mnk FLOPs against one
#   4mn-byte read of V.
# Design: one block owns a row block of the output for the whole n loop
#   (no span split, no second kernel, identical bits over reruns), keeps
#   its W rows in shared memory, and streams V tiles and the H tiles they
#   meet through a two-stage cp.async ring.  Both products run on the
#   tensor cores in 3xTF32, and V_hat is built over all of k once per
#   tile; above k = 128 the output columns are split over warps, whose
#   parts of V_hat meet in shared memory.  Tiers by k: csrc/fused_dma.cu.
# ---------------------------------------------------------------------------

def kl_phi_dot_ht_dma_reference(V, W, H):
    """Plain PyTorch version of :func:`kl_phi_dot_ht_dma`."""
    return (V / (W @ H)) @ H.T


def kl_phi_dot_ht_dma(V, W, H):
    """(V / (W @ H)) @ H' with V and H streamed through shared memory."""
    global kl_phi_dot_ht_dma_launches
    if _on_cpu(V, W, H, "kl", MAX_K):
        return kl_phi_dot_ht_dma_reference(V, W, H)
    lib = _build.load()
    m, n = V.shape
    k = W.shape[1]
    out = torch.empty((m, k), dtype=torch.float32, device=V.device)
    with torch.cuda.device(V.device):
        err = lib.nmf_kl_phi_dot_ht_dma(
            V.data_ptr(), W.data_ptr(), H.data_ptr(), out.data_ptr(), m, n, k,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, "nmf_kl_phi_dot_ht_dma", err)
    kl_phi_dot_ht_dma_launches += 1
    return out
