"""Solvers (PyTorch counterparts of ``nmf_toolbox_tpu/models``)."""
from .batched import nmf_batched, nmf_encode, nmf_multiseed
from .hals import nmf_hals
from .nmf import nmf

__all__ = ["nmf", "nmf_hals", "nmf_batched", "nmf_multiseed", "nmf_encode"]
