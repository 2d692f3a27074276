"""Gram-matrix utilities: pos/neg splits and Gram-form Euclidean costs.

PyTorch counterpart of ``nmf_toolbox_tpu/ops/gram.py``.  The semi-NMF /
convex family splits Gram matrices into positive and negative parts
(convexnmf.m:86-87, seminmf.m:73-76, chnmf.m:169-172):

    A_pos = (|A| + A) / 2,   A_neg = (|A| - A) / 2.

0.5*||V - W H||_F^2 is evaluated from k-by-k Grams without ever
materializing the m-by-n reconstruction, so an iteration of the
Euclidean path needs two full-size matmuls instead of ~6.
"""
from __future__ import annotations

import torch


def pos_neg_split(A):
    """Return (A_pos, A_neg) with A = A_pos - A_neg, both non-negative."""
    absA = torch.abs(A)
    return 0.5 * (absA + A), 0.5 * (absA - A)


def sq_norm(V):
    """||V||_F^2 (precomputed once; constant across iterations)."""
    return torch.sum(V * V)


def euclidean_cost_gram(v_sq, WtV, WtW, H):
    """0.5*||V - W H||^2 = 0.5*(||V||^2 - 2<W'V, H> + <W'W H, H>).

    All operands are k-by-n / k-by-k; no m-by-n intermediate.  Clamped at
    zero: the identity cancels catastrophically once the true residual
    nears the dtype's precision floor, while the reference's residual form
    (nmf.m:208) is nonnegative by construction.
    """
    c = 0.5 * (v_sq - 2.0 * torch.sum(WtV * H) + torch.sum((WtW @ H) * H))
    return torch.clamp_min(c, 0.0)


def euclidean_cost_gram_w(v_sq, VHt, HHt, W):
    """Same identity arranged for a W line search (H fixed):
    0.5*(||V||^2 - 2<V H', W> + <W'W, H H'>)."""
    WtW = W.T @ W
    c = 0.5 * (v_sq - 2.0 * torch.sum(VHt * W) + torch.sum(WtW * HHt))
    return torch.clamp_min(c, 0.0)


def conv_cross_grams_w(W):
    """WW[t, s] = W[:, :, t]' @ W[:, :, s]  -> (T, T, k, k)."""
    return torch.einsum("mkt,mls->tskl", W, W)


def conv_cross_grams_h(Hs):
    """HH[t, s] = Hs[t] @ Hs[s]'  -> (T, T, k, k) for stacked shifted H."""
    return torch.einsum("tkn,sln->tskl", Hs, Hs)
