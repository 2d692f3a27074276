"""Solvers (PyTorch counterparts of ``nmf_toolbox_tpu/models``)."""
from .batched import (cmfwisa_encode, cnmf_encode, nmf2d_encode, nmf_batched,
                      nmf_encode, nmf_multiseed)
from .chcnmf import chcnmf
from .chnmf import chnmf
from .cmfwisa import cmfwisa
from .cnmf import cnmf
from .cnmfsc import cnmfsc
from .constrainednmf import constrainednmf
from .convexnmf import convexnmf
from .hals import nmf_hals
from .lnmf import lnmf
from .nmf import nmf
from .nmf2d import nmf2d
from .nmfsc import nmfsc
from .seminmf import seminmf
from .streaming import nmf_encode_streaming, nmf_streaming
from .symnmf import symnmf

__all__ = ["nmf", "lnmf", "seminmf", "convexnmf", "chnmf", "cnmf", "nmfsc",
           "cnmfsc", "cmfwisa", "chcnmf", "constrainednmf", "nmf_hals",
           "nmf_streaming", "nmf_encode_streaming", "nmf_batched",
           "nmf_multiseed", "nmf_encode", "cnmf_encode", "cmfwisa_encode",
           "nmf2d", "nmf2d_encode", "symnmf"]
