"""Utilities (PyTorch counterparts of ``nmf_toolbox_tpu/utils``)."""
from .init import nndsvd, seedable

__all__ = ["nndsvd", "seedable"]
