"""Hand-written CUDA kernels (counterparts of ``nmf_toolbox_tpu/ops/pallas``).

The kernel library is built and loaded at first launch, never at import.
"""
from .fused import cost_terms, phi_dot_ht, wt_dot_phi

__all__ = ["phi_dot_ht", "wt_dot_phi", "cost_terms"]
