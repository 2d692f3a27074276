"""Hand-written CUDA kernels (counterparts of ``nmf_toolbox_tpu/ops/pallas``).

The kernel library is built and loaded at first launch, never at import.
"""
