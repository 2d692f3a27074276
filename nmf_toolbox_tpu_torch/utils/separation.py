"""Wiener-filter source separation from NMF factors.

PyTorch counterpart of ``nmf_toolbox_tpu/utils/separation.py``.  The
reference stops at the factorization ("reconstruct each source as
W_i @ H_i", nmf.m:136-137, cmfwisa.m:164-169); direct reconstruction
drops the part of the mixture the models did not fit.  Soft masking
(Fevotte et al. 2009) keeps it:

    mask_i = (W_i H_i)^p / sum_j (W_j H_j)^p,     est_i = mask_i * V

p=2 is the Wiener filter, p=1 ratio masking on magnitudes.  The
estimates sum to V, and for a complex STFT V the (real) masks reuse the
mixture phase.  Masking is elementwise over (S, m, n) on the device.
"""
from __future__ import annotations

import torch

from ..core import EPS, as_tensor, resolve_device, resolve_dtype
from ..ops.shift import reconstruct
from .audio import _complex_of_planes, _istft

__all__ = ["wiener_masks", "separate", "separate_waveforms"]


def _stack_models(W, H, device):
    """Per-source reconstructions (S, m, n) from lists of (W_i, H_i); each
    W_i 2-D (m, k_i) or a convolutive (m, k_i, T) basis (and H_i nmf2d's
    (k_i, n, P)), through ops.shift.reconstruct."""
    if not isinstance(W, (list, tuple)) or not isinstance(H, (list, tuple)):
        raise TypeError(
            "W and H must be lists of per-source factors (the multi-source "
            "output shape of nmf/cmfwisa, or any [W_i], [H_i] pairing)")
    if len(W) != len(H) or not W:
        raise ValueError(f"need matching non-empty factor lists; got "
                         f"{len(W)} bases and {len(H)} encodings")
    return torch.stack([reconstruct(Wi, Hi, device=device) for Wi, Hi in zip(W, H)])


def wiener_masks(W, H, power: float = 2.0, eps: float = EPS, device=None):
    """Soft masks (S, m, n) from per-source factor lists.

    ``power``: exponent on the model magnitudes (2.0 = Wiener / power
    ratios, 1.0 = magnitude ratios).  Masks are non-negative and sum to
    one over sources at every bin (1/S where every model is zero, so the
    decomposition stays exact).  Tensor factors stay on their device;
    arrays go to ``device`` (default: the card).
    """
    fields = torch.abs(_stack_models(W, H, device)) ** power
    total = torch.sum(fields, dim=0, keepdim=True)
    # Where all models vanish the ratio is 0/0; share the bin equally so
    # sum_i est_i == V still holds.
    return torch.where(total > eps, fields / torch.clamp_min(total, eps),
                       1.0 / fields.shape[0])


def separate(V, W, H, power: float = 2.0, eps: float = EPS, device=None):
    """Per-source estimates (S, m, n) with sum_i est_i == V.

    ``V``: the mixture the factors were fit to, a magnitude or a complex
    STFT (complex V reuses the mixture phase per source, since the masks
    are real).  ``W``/``H``: lists of per-source factors.  Returns a
    stacked tensor on V's device; ``out[i]`` is source i.
    """
    dev = resolve_device(V, device)
    V = as_tensor(V, resolve_dtype(V, None), dev)
    masks = wiener_masks(W, H, power=power, eps=eps, device=dev)
    if V.shape != masks.shape[1:]:
        raise ValueError(f"V has shape {tuple(V.shape)}; factors reconstruct "
                         f"{tuple(masks.shape[1:])}")
    return masks * V[None]


def separate_waveforms(Z, W, H, *, hop_length=None, window="hann",
                       center=True, length=None, power: float = 2.0,
                       device=None):
    """Decode to waveforms: Wiener masks, the mixture's phase, iSTFT.

    ``Z``: the mixture's complex STFT ``(freq, frames)``, or the real
    ``(2, freq, frames)`` plane stack from ``stft(..., planes=True)``.
    ``W``/``H``: per-source factor lists as in :func:`separate` (a single
    factor is taken as one source).  Returns the stacked real waveforms
    ``(S, length)``, equal to ``separate`` followed by ``istft`` per
    source.
    """
    dev = resolve_device(Z, device)
    Z = as_tensor(Z, resolve_dtype(Z, None), dev)
    if not Z.is_complex():
        if Z.ndim < 3 or Z.shape[0] != 2:
            raise ValueError("real Z must be a (2, freq, frames) plane "
                             f"stack; got {tuple(Z.shape)}")
        Z = _complex_of_planes(Z)
    W = list(W) if isinstance(W, (list, tuple)) else [W]
    H = list(H) if isinstance(H, (list, tuple)) else [H]
    masks = wiener_masks(W, H, power=power, device=dev)
    if Z.shape != masks.shape[1:]:
        raise ValueError(f"Z has shape {tuple(Z.shape)}; factors "
                         f"reconstruct {tuple(masks.shape[1:])}")
    est = masks.to(Z.real.dtype) * Z[None]
    return _istft(est, hop_length, window, center, length)
