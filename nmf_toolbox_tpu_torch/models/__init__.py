"""Solvers (PyTorch counterparts of ``nmf_toolbox_tpu/models``)."""
from .hals import nmf_hals
from .nmf import nmf

__all__ = ["nmf", "nmf_hals"]
