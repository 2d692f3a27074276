"""Normalization conventions (PyTorch counterpart of
``nmf_toolbox_tpu/ops/normalize.py``).  These differ per algorithm and
are load-bearing."""
from __future__ import annotations

import torch


def unit_l2_columns(W):
    """W * diag(1/||w_k||_2) — nmf.m:133,169; cmfwisa.m:154,193.  A batch
    (B, m, k) normalizes each problem's columns."""
    return W / torch.sqrt(torch.sum(W * W, dim=-2, keepdim=True))


def unit_sum_columns(X):
    """X * diag(1/sum(x_k)) — lnmf.m:64,75; convexnmf.m:83,95; chnmf.m:115,181."""
    return X / torch.sum(X, dim=0, keepdim=True)


def row_l2_transfer(H, W):
    """Normalize rows of H to unit L2, pushing the norms into W's columns
    (nmfsc.m:184-187; cnmfsc.m:204-209 for a (m, k, T) basis tensor).
    Returns (H_normalized, W_scaled)."""
    norms = torch.sqrt(torch.sum(H * H, dim=1))  # (k,)
    H = H / norms[:, None]
    if W.ndim == 2:
        W = W * norms[None, :]
    else:
        W = W * norms[None, :, None]
    return H, W


def cross_frame_norm(W, H=None, context_len: int | None = None,
                     return_norms: bool = False):
    """Per-basis-element cross-frame normalization for the convolutive basis.

    w_norm_k = ||W[:, k, :]||_F / T; W[:, k, :] /= w_norm_k, and (at init
    only) H[k, :] *= w_norm_k.  Reference: cnmf.m:157-166, 196-199.
    Returns (W, H) (H unchanged if None), or (W, norms) with
    ``return_norms``.
    """
    T = context_len if context_len is not None else W.shape[2]
    norms = torch.sqrt(torch.sum(W * W, dim=(0, 2))) / T  # (k,)
    W = W / norms[None, :, None]
    if return_norms:
        return W, norms
    if H is not None:
        H = H * (norms[:, None] if H.ndim == 2 else norms[None, :, None])
    return W, H
