"""The naive KL step's field and cost, one pass over the m-by-n fields each.

The naive step (``models/nmf.py``) builds the reconstruction V_hat = W @ H
and runs the KL field and cost over it.  Written as eager torch ops they
are chains of passes over m-by-n tensors (four for a weighted field, nine
for a weighted cost, six unweighted); the JAX package's jitted loop has
XLA fuse each chain into one.  These wrappers give that fusion back with
the two streaming kernels of ``csrc/naive_kl.cu``.  The unweighted field
V / V_hat is one torch pass already and keeps ``ops/divergence.py``.

Each wrapper takes f32, 2-D, same-shape ``V``, ``V_hat`` and weights
``M`` (the cost also takes None: unweighted).  Tensors on the CPU go to the plain
PyTorch version beside it (``*_reference``: the expressions of
``ops/divergence.py`` for KL); tensors on a CUDA device must be
contiguous and launch the kernel on the current stream, or raise.
Nothing falls back.  Each launch adds one to the wrapper's counter
(``kl_field_launches``, ``kl_cost_launches``).
"""
from __future__ import annotations

import torch

from .. import divergence as dv
from . import _build
from .fused import _raise_on

kl_field_launches = 0
kl_cost_launches = 0


def takes(V, mask=None) -> bool:
    """Whether the naive KL step runs its field and cost here: V a CUDA
    f32 tensor and no padding mask (a padded mesh block keeps
    ``ops/divergence.py``)."""
    return mask is None and V.is_cuda and V.dtype == torch.float32


def _on_cpu(V, V_hat, M) -> bool:
    """Validate the operands; True for CPU tensors, False for CUDA ones."""
    named = (("V", V), ("V_hat", V_hat)) + ((("M", M),) if M is not None else ())
    for name, x in named:
        if not torch.is_tensor(x) or x.ndim != 2 or x.dtype != torch.float32:
            raise TypeError(f"{name} must be a 2-D float32 tensor")
    for name, x in named[1:]:
        if x.shape != V.shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, V {tuple(V.shape)}")
    if any(x.device != V.device for _, x in named):
        raise ValueError("V, V_hat and M must lie on one device")
    if V.device.type == "cpu":
        return True
    if V.device.type != "cuda":
        raise ValueError(f"no kernel for device {V.device}")
    if not all(x.is_contiguous() for _, x in named):
        raise ValueError("V, V_hat and M must be contiguous")
    return False


def _ptr(x):
    return 0 if x is None else x.data_ptr()


# ---------------------------------------------------------------------------
# Field: phi = M > 0 ? M * (V / V_hat) : 0
#
# Replaces: no pallas_call; the fusion XLA makes of
#   nmf_toolbox_tpu/ops/divergence.py fields (weighted KL) inside the
#   naive step's jitted loop.  The W and the H update each take one.
# Bound on the H100: bytes, one read of each input and one write of phi:
#   16 bytes an entry, 1.91 ms at 40 000x10 000.
# Design: one float4 of each operand a thread, a block to every NT of
#   them, scalar where a pointer is not 16-byte aligned and at the tail;
#   every entry rounded as torch's chain rounds it (bit for bit).
# ---------------------------------------------------------------------------

def kl_field_reference(V, V_hat, M):
    """Plain PyTorch version of :func:`kl_field` (``dv.fields``' weighted
    KL field)."""
    return dv.fields("kl", V, V_hat, weights=M)[0]


def kl_field(V, V_hat, M):
    """The KL field V / V_hat weighted by ``M``, zero-weight entries
    hard-zeroed (a missing entry may carry NaN): an (m, n) f32 tensor."""
    global kl_field_launches
    if M is None:
        raise TypeError("M must be a 2-D float32 tensor: the unweighted field "
                        "is V / V_hat")
    if _on_cpu(V, V_hat, M):
        return kl_field_reference(V, V_hat, M)
    lib = _build.load()
    phi = torch.empty_like(V)
    with torch.cuda.device(V.device):
        err = lib.nmf_kl_field(V.data_ptr(), V_hat.data_ptr(), _ptr(M), phi.data_ptr(),
                               V.numel(), torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, "nmf_kl_field", err)
    kl_field_launches += 1
    return phi


# ---------------------------------------------------------------------------
# Cost: sum(M > 0 ? M * (V log(V / V_hat) - V + V_hat) : 0), or unweighted
#
# Replaces: no pallas_call; the fusion of nmf_toolbox_tpu/ops/divergence.py
#   cost (KL, through _weighted_sum) in the naive step's loop.
# Bound on the H100: bytes, one read of each input: 12 (unweighted 8)
#   bytes an entry, 1.43 (0.96) ms at 40 000x10 000.
# Design: the field's loop, each term rounded as torch's chain rounds it,
#   summed in f64 per thread, warp and block into one partial a block; a
#   one-block kernel adds the partials in a fixed order and rounds to f32
#   (the same bits every run).  Under a mesh it is this block's sum; the
#   caller adds the ranks.
# ---------------------------------------------------------------------------

def kl_cost_terms_reference(V, V_hat, M=None):
    """Plain PyTorch version of :func:`kl_cost_terms` (``dv.cost`` for KL)."""
    return dv.cost("kl", V, V_hat, weights=M)


def kl_cost_terms(V, V_hat, M=None):
    """The KL cost of (V, V_hat), weighted by ``M``: a 0-d f32 tensor on
    V's device."""
    global kl_cost_launches
    if _on_cpu(V, V_hat, M):
        return kl_cost_terms_reference(V, V_hat, M)
    lib = _build.load()
    out = torch.empty((), dtype=torch.float32, device=V.device)
    with torch.cuda.device(V.device):
        count = lib.nmf_kl_cost_partials(V.numel(), int(M is not None))
        if count < 1:
            raise RuntimeError("nmf_kl_cost_partials could not plan on this card")
        part = torch.empty((count,), dtype=torch.float64, device=V.device)
        err = lib.nmf_kl_cost(V.data_ptr(), V_hat.data_ptr(), _ptr(M), part.data_ptr(),
                              out.data_ptr(), V.numel(),
                              torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, "nmf_kl_cost", err)
    kl_cost_launches += 1
    return out
