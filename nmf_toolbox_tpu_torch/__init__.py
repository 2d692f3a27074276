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
from .models import (chcnmf, chnmf, cmfwisa, cmfwisa_encode, cnmf, cnmf_encode,
                     cnmfsc, constrainednmf, convexnmf, lnmf, nmf, nmf2d,
                     nmf2d_encode, nmf_batched, nmf_encode, nmf_encode_streaming,
                     nmf_hals, nmf_multiseed, nmf_streaming, nmfsc, seminmf, symnmf)
from .ops.projection import projfunc
from .ops.shift import reconstruct
from .rank import consensus_stability, estimate_rank_svd, pick_rank
from .utils import (griffinlim, istft, magnitude, separate, separate_waveforms,
                    stft, wiener_masks)

reconstruct_from_decomposition = reconstruct  # the reference's name

__all__ = ["EPS", "Result", "reconstruct", "reconstruct_from_decomposition",
           "projfunc", "nmf", "lnmf", "seminmf", "convexnmf", "chnmf", "cnmf",
           "nmfsc", "cnmfsc", "cmfwisa", "chcnmf", "constrainednmf", "nmf_hals",
           "nmf_streaming", "nmf_encode_streaming", "nmf_batched", "nmf_multiseed",
           "nmf_encode", "cnmf_encode", "cmfwisa_encode", "nmf2d", "nmf2d_encode",
           "symnmf", "wiener_masks", "separate", "separate_waveforms", "stft",
           "istft", "griffinlim", "magnitude", "pick_rank", "consensus_stability",
           "estimate_rank_svd"]
__version__ = "1.1.0"  # the distribution's version (pyproject.toml)
