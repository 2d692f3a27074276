"""Solvers (PyTorch counterparts of ``nmf_toolbox_tpu/models``)."""
from .batched import nmf_batched, nmf_encode, nmf_multiseed
from .chnmf import chnmf
from .constrainednmf import constrainednmf
from .convexnmf import convexnmf
from .hals import nmf_hals
from .lnmf import lnmf
from .nmf import nmf
from .seminmf import seminmf
from .streaming import nmf_encode_streaming, nmf_streaming
from .symnmf import symnmf

__all__ = ["nmf", "lnmf", "seminmf", "convexnmf", "chnmf", "constrainednmf",
           "nmf_hals", "nmf_streaming", "nmf_encode_streaming", "nmf_batched",
           "nmf_multiseed", "nmf_encode", "symnmf"]
