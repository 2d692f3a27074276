"""nmf_toolbox_tpu_torch — the PyTorch + CUDA port of nmf_toolbox_tpu.

It mirrors the JAX package's module names and call surface, so each
module here has a counterpart there, and is held against it by the
tests.  It imports ``torch`` and never ``jax``.  The KL/IS hot loop of
``nmf(..., method="fused")`` runs hand-written CUDA kernels
(``csrc/fused.cu``; the streamed W-phase variant is ``csrc/fused_dma.cu``),
built with ``nvcc`` at first use; on CPU tensors their plain PyTorch
versions run instead.
"""
from .core import EPS, Result
from .models import (chnmf, constrainednmf, convexnmf, lnmf, nmf, nmf_batched,
                     nmf_encode, nmf_encode_streaming, nmf_hals, nmf_multiseed,
                     nmf_streaming, seminmf, symnmf)
from .rank import consensus_stability, estimate_rank_svd, pick_rank

__all__ = ["EPS", "Result", "nmf", "lnmf", "seminmf", "convexnmf", "chnmf",
           "constrainednmf", "nmf_hals", "nmf_streaming", "nmf_encode_streaming",
           "nmf_batched", "nmf_multiseed", "nmf_encode", "symnmf", "pick_rank",
           "consensus_stability", "estimate_rank_svd"]
__version__ = "1.1.0"  # the distribution's version (pyproject.toml)
