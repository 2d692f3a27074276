"""Solvers (PyTorch counterparts of ``nmf_toolbox_tpu/models``)."""
from .nmf import nmf

__all__ = ["nmf"]
