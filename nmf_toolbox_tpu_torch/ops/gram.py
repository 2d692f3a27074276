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

from ..parallel.collectives import sum_samples
from .shift import shift_sum, stack_shifts_right


def pos_neg_split(A):
    """Return (A_pos, A_neg) with A = A_pos - A_neg, both non-negative."""
    absA = torch.abs(A)
    return 0.5 * (absA + A), 0.5 * (absA - A)


def vdot(A, B, vdt):
    """A @ B where one operand is V in its storage dtype ``vdt``: a bf16 or
    f16 V takes low-precision operands and accumulates in f32
    (``data_dtype``); a 2-D operand meets a 3-D batch by broadcasting."""
    A, B = A.to(vdt), B.to(vdt)
    if vdt.itemsize >= 4:
        return A @ B
    if A.is_cuda:
        if A.ndim == B.ndim == 2:
            return torch.mm(A, B, out_dtype=torch.float32)
        batch = max(x.shape[0] for x in (A, B) if x.ndim == 3)
        A, B = (x.expand(batch, *x.shape[-2:]) for x in (A, B))
        return torch.bmm(A, B, out_dtype=torch.float32)
    # The CPU build has no out_dtype overload: upcast the low-precision
    # operands (exact) and multiply in f32.
    return A.float() @ B.float()


def sq_norm(V, dim=None):
    """||V||_F^2 (precomputed once; constant across iterations); per
    matrix of a batch with ``dim=(-2, -1)``."""
    return torch.sum(V * V, dim=dim)


def euclidean_cost_gram(v_sq, WtV, WtW, H, dim=None, mesh=None):
    """0.5*||V - W H||^2 = 0.5*(||V||^2 - 2<W'V, H> + <W'W H, H>).

    All operands are k-by-n / k-by-k; no m-by-n intermediate.  Clamped at
    zero: the identity cancels catastrophically once the true residual
    nears the dtype's precision floor, while the reference's residual form
    (nmf.m:208) is nonnegative by construction.  ``dim=(-2, -1)`` gives
    one cost per problem of a batch.  ``mesh``: H and W'V hold this rank's
    columns (W'V and W'W already summed over features, ``v_sq`` over every
    rank), and the two inner products sum over samples in one collective.
    """
    a, b = torch.sum(WtV * H, dim=dim), torch.sum((WtW @ H) * H, dim=dim)
    if mesh is not None:
        a, b = sum_samples(mesh, a, b)
    c = 0.5 * (v_sq - 2.0 * a + b)
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
    """HH[t, s] = Hs[t] @ Hs[s]'  -> (..., T, T, k, k) for stacked shifted H
    (..., T, k, n); leading dimensions are a batch of problems."""
    return torch.einsum("...tkn,...sln->...tskl", Hs, Hs)


def conv_wt_vhat_gram(WW, H, mesh=None, Hs=None):
    """conv_wt_phi(W, conv_reconstruct(W, H)) -> (..., k, n) from the
    cross-Grams WW = conv_cross_grams_w(W): sum_t shift_left(sum_s
    W_t' W_s Hs[s], t), with no m-by-n reconstruction.  Leading
    dimensions of H are a batch of problems.  ``Hs``: H's shift stack
    when the caller has it; ``mesh``: H holds this rank's columns (WW
    summed over features), and the left shifts read the next blocks."""
    if Hs is None:
        Hs = stack_shifts_right(H, WW.shape[0], mesh=mesh)
    return shift_sum(torch.einsum("tskl,...sln->...tkn", WW, Hs), mesh)


def conv_euclidean_cost_gram(v_sq, WtV, WW, H, n_valid=None, mesh=None):
    """0.5*||V - conv_reconstruct(W, H)||^2 = 0.5*(||V||^2
    - 2<conv_wt_phi(W, V), H> + <WW, HH>), HH the cross-Grams of H's
    shift stack, clamped at zero as :func:`euclidean_cost_gram`.  Leading
    dimensions of H (and of v_sq and WtV) are a batch: one cost each.
    ``mesh``: H and WtV hold this rank's columns (WtV and WW summed over
    features, ``v_sq`` over every rank), and the sample-side sums run in
    one collective; ``n_valid`` as in ``ops/shift.stack_shifts_right``."""
    HH = conv_cross_grams_h(stack_shifts_right(H, WW.shape[0], n_valid, mesh))
    lin = torch.sum(WtV * H, dim=(-2, -1))
    if mesh is not None:
        lin, HH = sum_samples(mesh, lin, HH)
    c = 0.5 * (v_sq - 2.0 * lin + torch.sum(WW * HH, dim=(-4, -3, -2, -1)))
    return torch.clamp_min(c, 0.0)
