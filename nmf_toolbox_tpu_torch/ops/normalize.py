"""Normalization conventions (PyTorch counterpart of
``nmf_toolbox_tpu/ops/normalize.py``).  These differ per algorithm and
are load-bearing."""
from __future__ import annotations

import math

import torch

from ..parallel.collectives import sum_axis, sum_features, sum_samples


def _col_sq(W, mesh):
    """Squared column norms over all of m: a rank's rows of W on a mesh
    with a feature axis sum with the other rows' (parallel/collectives)."""
    return sum_features(mesh, torch.sum(W * W, dim=-2, keepdim=True))


def unit_l2_columns(W, mesh=None):
    """W * diag(1/||w_k||_2) — nmf.m:133,169; cmfwisa.m:154,193.  A batch
    (B, m, k) normalizes each problem's columns.  ``mesh``: W holds this
    rank's rows, and the norm runs over every rank's."""
    return W / torch.sqrt(_col_sq(W, mesh))


def unit_l2_columns_entry(W, mesh=None):
    """:func:`unit_l2_columns` for a solver's entry (nmf.m:132-134), which
    leaves as they are the columns whose squared norm is already 1 to the
    rounding of its sum, (log2 m + 4) ulps: a W that a solver returned,
    as ``run_checkpointed`` hands it to its next chunk.  Dividing such a
    column by a norm that rounds to 1 +- a few ulps would move it by those
    ulps, and a chunked run would drift from one call; any other column
    is divided exactly as :func:`unit_l2_columns` divides it.  ``mesh`` as
    in :func:`unit_l2_columns`; the tolerance counts the global m."""
    sq = _col_sq(W, mesh)
    m = W.shape[-2] * (1 if mesh is None else mesh.size("m"))
    tol = (math.log2(max(m, 1)) + 4) * torch.finfo(W.dtype).eps
    return torch.where(torch.abs(sq - 1) <= tol, W, W / torch.sqrt(sq))


def unit_sum_columns(X, mesh=None, axis="m"):
    """X * diag(1/sum(x_k)) — lnmf.m:64,75; convexnmf.m:83,95; chnmf.m:115,181.
    ``mesh``: X holds this rank's rows, which lie along the mesh axis
    ``axis``, and the sums run over every rank's."""
    return X / sum_axis(mesh, axis, torch.sum(X, dim=0, keepdim=True))


def row_l2_transfer(H, W, mesh=None):
    """Normalize rows of H to unit L2, pushing the norms into W's columns
    (nmfsc.m:184-187; cnmfsc.m:204-209 for a (m, k, T) basis tensor).
    Returns (H_normalized, W_scaled).  ``mesh``: H holds this rank's
    columns, and the norms run over every rank's."""
    norms = torch.sqrt(sum_samples(mesh, torch.sum(H * H, dim=1)))  # (k,)
    H = H / norms[:, None]
    if W.ndim == 2:
        W = W * norms[None, :]
    else:
        W = W * norms[None, :, None]
    return H, W


def cross_frame_norm(W, H=None, context_len: int | None = None,
                     return_norms: bool = False, mesh=None):
    """Per-basis-element cross-frame normalization for the convolutive basis.

    w_norm_k = ||W[:, k, :]||_F / T; W[:, k, :] /= w_norm_k, and (at init
    only) H[k, :] *= w_norm_k.  Reference: cnmf.m:157-166, 196-199.
    Returns (W, H) (H unchanged if None), or (W, norms) with
    ``return_norms``.  ``mesh``: W holds this rank's rows, and the norms
    run over every rank's.
    """
    T = context_len if context_len is not None else W.shape[2]
    norms = torch.sqrt(sum_features(mesh, torch.sum(W * W, dim=(0, 2)))) / T  # (k,)
    W = W / norms[None, :, None]
    if return_norms:
        return W, norms
    if H is not None:
        H = H * (norms[:, None] if H.ndim == 2 else norms[None, :, None])
    return W, H
