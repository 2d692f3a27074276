"""Time- and pitch-shift operators for the convolutive family.

PyTorch counterpart of ``nmf_toolbox_tpu/ops/shift.py``.  Two shifts
appear in the reference (cnmf.m:181, 219):

  * H shifted RIGHT by t:   [zeros(k, t), H(:, 1:n-t)]
  * V/targets shifted LEFT: [V(:, t+1:n), zeros(m, t)]

(t is 0-based here; MATLAB writes t-1.)  Every product over the T
shifts is ONE GEMM over T*k: a convolutive basis W (m, k, T) is read as
the flat (m, T*k) matrix of its frames side by side
(:func:`flatten_frames`), and the right-shifted copies of H as the
(T*k, n) stack of :func:`stack_shifts_right` in the same (t, k) order.
Leading batch dimensions of H or of a field broadcast through every
operator, which is how the encode engines run all problems at once.

The 2-D deconvolution of ``nmf2d`` adds a row shift by p (pitch) and
uses shift_down(W, p)' @ X == W' @ shift_up(X, p): the P row-shifted
copies of the flat basis stand side by side as one (m, P*T*k) matrix
(:func:`pitch_frames`), so its reconstruction and both gradients are
also one GEMM each, and no (P, m, n) stack of fields is formed.

Under a ``mesh`` the last axis of H and of the fields is this rank's
block of the sample axis.  A right shift reads the T - 1 columns before
the block, a left shift the T - 1 after it: both come from
``parallel.collectives.halo`` (zeros past the global edge), so every
shifted operator gives this block's columns of the unsharded result.
``n_valid`` is the true n of a mesh-padded problem: a right shift stops
there, as in the JAX package, or valid columns would spill into the pad.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core import as_tensor, resolve_device, resolve_dtype
from ..parallel.collectives import halo
from ..parallel.mesh import block_offset


def shift_right(X, t: int):
    """[zeros(:, t), X(:, :n-t)] along the last axis."""
    if t == 0:
        return X
    return F.pad(X, (t, 0))[..., : X.shape[-1]]


def shift_left(X, t: int):
    """[X(:, t:), zeros(:, t)] along the last axis."""
    if t == 0:
        return X
    return F.pad(X, (0, t))[..., t:]


def shift_down_rows(X, p: int):
    """[zeros(p, :); X(1:m-p, :)] along axis -2 (nmf2d's pitch shift on a
    log-frequency axis)."""
    if p == 0:
        return X
    return F.pad(X, (0, 0, p, 0))[..., : X.shape[-2], :]


def shift_up_rows(X, p: int):
    """[X(p+1:, :); zeros(p, :)] along axis -2, the adjoint of
    :func:`shift_down_rows` (shift_down(W, p)' @ X == W' @ shift_up(X, p))."""
    if p == 0:
        return X
    return F.pad(X, (0, 0, 0, p))[..., p:, :]


def stack_shifts_right(H, T: int, n_valid: int | None = None, mesh=None):
    """(..., T, k, n): the right-shifted copies of H (..., k, n) for
    t = 0 .. T-1, contiguous.  The windows of H with its T-1 columns of
    left context (zeros, or the halo under a ``mesh``) are its shifts in
    reverse order, so the stack is one concatenation and one flipped copy
    whatever T is.  Columns at or past ``n_valid`` are zero."""
    n = H.shape[-1]
    Hp = (F.pad(H, (T - 1, 0)) if mesh is None
          else torch.cat([halo(mesh, H, T - 1, "left"), H], dim=-1))
    windows = Hp.unfold(-1, n, 1)  # (..., k, T, n): shift T-1-o
    Hs = windows.transpose(-3, -2).flip(-3)
    off = block_offset(mesh, n)
    if n_valid is not None and n_valid < off + n:
        cols = torch.arange(off, off + n, device=H.device) < n_valid
        Hs = torch.where(cols, Hs, torch.zeros((), dtype=Hs.dtype, device=Hs.device))
    return Hs


def shifted_row_sums(H, T: int, n_true: int, offset: int = 0):
    """(..., k, T): column t holds the sum of H over the global columns
    before n_true - t (ones(m, n) @ shift_right(H, t)' of the true n), as
    far as this block of H, whose first global column is ``offset``,
    holds them: its share of a sum over samples."""
    b = H.shape[-1]
    last = n_true - 1 - offset - torch.arange(T, device=H.device)  # local column
    vals = torch.cumsum(H, dim=-1)[..., last.clamp(0, b - 1)]
    return torch.where(last >= 0, vals, torch.zeros((), dtype=H.dtype, device=H.device))


def flatten_frames(W):
    """W (m, k, T) as the (m, T*k) matrix [W_0 | W_1 | ... | W_{T-1}],
    in the (t, k) order of a flattened :func:`stack_shifts_right`."""
    m, k, T = W.shape
    return W.permute(0, 2, 1).reshape(m, T * k)


def unflatten_frames(X, T: int):
    """(..., m, T*k) in the (t, k) order back to (..., m, k, T)."""
    return X.unflatten(-1, (T, -1)).transpose(-1, -2)


def shift_sum(Y, mesh=None):
    """sum_t shift_left(Y[..., t, :, :], t) over Y (..., T, k, n): Y with
    its T-1 columns of right context (zeros, or the halo under a
    ``mesh``), read along its diagonals (slab t from column t on), and
    summed over t; one concatenation and one sum whatever T is."""
    T = Y.shape[-3]
    Yp = (F.pad(Y, (0, T - 1)) if mesh is None
          else torch.cat([Y, halo(mesh, Y, T - 1, "right")], dim=-1))
    return _diagonal_sum(Yp, Y.shape, -3, -1)


def _diagonal_sum(Yp, shape, axis, along):
    """sum over ``axis`` of the view Z of the contiguous Yp with Z[.., a, .., j, ..]
    = Yp[.., a, .., j + a, ..] (``along`` the shifted axis), of ``shape``."""
    strides = list(Yp.stride())
    strides[axis] += strides[along]
    return Yp.as_strided(shape, strides, Yp.storage_offset()).sum(axis)


def conv_reconstruct(W, H, n_valid: int | None = None, mesh=None, Hs=None):
    """V_hat = sum_t W[:, :, t] @ shift_right(H, t) (ReconstructFromDecomposition.m:32-38)
    as one GEMM, W (m, T*k) @ Hs (T*k, n); H may carry batch dims.  ``Hs``:
    H's shift stack when the caller has it.  Under a ``mesh``, W's rows
    and H's columns are this rank's, and so are V_hat's."""
    T = W.shape[2]
    if Hs is None:
        Hs = stack_shifts_right(H, T, n_valid, mesh)
    return flatten_frames(W) @ Hs.flatten(-3, -2)


def conv_wt_phi(W, Phi, mesh=None):
    """sum_t W[:, :, t]' @ shift_left(Phi, t) -> (..., k, n): the H-update
    gradient of cnmf.m:216-227.  W_t' @ shift_left(Phi, t) ==
    shift_left(W_t' @ Phi, t), so this is one (T*k, m) @ (m, n) GEMM and T
    shifts of (k, n) slabs; no (T, m, n) stack is formed.  Under a
    ``mesh`` the shifts take their right context from the next blocks,
    and the result is this rank's share of a sum over features (the
    shifts are linear, so the caller sums the (k, n) result).  ``Phi``
    may stack several fields on a leading axis: they share one halo."""
    T = W.shape[2]
    return shift_sum((flatten_frames(W).T @ Phi).unflatten(-2, (T, -1)), mesh)


def phi_ht(Phi, Hs):
    """Phi @ Hs[t]' for every t of a shift stack Hs (..., T, k, n) ->
    (..., m, k, T), one GEMM; under a mesh, this block's share of a sum
    over samples."""
    T = Hs.shape[-3]
    return unflatten_frames(Phi @ Hs.flatten(-3, -2).mT, T)


def conv_phi_ht(Phi, H, T: int):
    """Phi @ shift_right(H, t)' for all t -> (..., m, k, T): the W-update
    gradient of cnmf.m:182-192 as one (m, n) @ (n, T*k) GEMM."""
    return phi_ht(Phi, stack_shifts_right(H, T))


def pitch_frames(W, P: int):
    """(m, P*T*k): the flat basis shifted down by p = 0 .. P-1, side by
    side, in the (p, t, k) order of :func:`stack_pitch_shifts` (the row
    windows of the basis padded with P-1 zero rows on top, reversed)."""
    Wf = flatten_frames(W)
    m = Wf.shape[0]
    windows = F.pad(Wf, (0, 0, P - 1, 0)).unfold(0, m, 1)  # (P, T*k, m): shift P-1-o
    return windows.flip(0).permute(2, 0, 1).reshape(m, -1)


def stack_pitch_shifts(H, T: int, n_valid: int | None = None, mesh=None):
    """(..., P*T*k, n): for each pitch p the (T*k, n) stack of right
    shifts of H[..., p] (H is (..., k, n, P)); ``n_valid`` and ``mesh``
    as in :func:`stack_shifts_right`."""
    return stack_shifts_right(H.movedim(-1, -3), T, n_valid, mesh).flatten(-4, -2)


def conv_reconstruct_2d(W, H, n_valid: int | None = None, mesh=None, Hs=None):
    """2-D deconvolutional reconstruction (models/nmf2d.py):
    sum_t sum_p shift_down(W[:, :, t], p) @ shift_right(H[:, :, p], t),
    W (m, k, T), H (..., k, n, P) -> (..., m, n), as one GEMM over P*T*k.
    ``Hs``: :func:`stack_pitch_shifts` of H when the caller has it."""
    T, P = W.shape[2], H.shape[-1]
    if Hs is None:
        Hs = stack_pitch_shifts(H, T, n_valid, mesh)
    return pitch_frames(W, P) @ Hs


def conv_wt_phi_2d(W, Phi, P: int, mesh=None):
    """nmf2d's H gradient: for each p, conv_wt_phi(W, shift_up_rows(Phi, p))
    -> (..., k, n, P), as one (P*T*k, m) @ (m, n) GEMM and the T shifts
    (their right context from the next blocks under a ``mesh``, whose
    feature axis nmf2d keeps replicated)."""
    T = W.shape[2]
    Y = (pitch_frames(W, P).T @ Phi).unflatten(-2, (P, T, -1))  # (..., P, T, k, n)
    return shift_sum(Y, mesh).movedim(-3, -1)


def conv_phi_ht_2d(Phi, H, T: int, Hs=None):
    """nmf2d's W gradient: sum_p shift_up(Phi, p) @ shift_right(H[..., p], t)'
    for all t -> (m, k, T).  shift_up(Phi, p) @ X == shift_up(Phi @ X, p),
    so one (m, n) @ (n, P*T*k) GEMM and P row shifts of (m, T*k) slabs.
    ``Hs``: :func:`stack_pitch_shifts` of H when the caller has it (under
    a mesh, this block's share of a sum over samples)."""
    P = H.shape[-1]
    if Hs is None:
        Hs = stack_pitch_shifts(H, T)
    Y = (Phi @ Hs.mT).unflatten(-1, (P, -1))  # (m, P, T*k)
    # sum_p shift_up_rows(Y[:, p], p): Y padded with P-1 zero rows, read
    # along its diagonals (slab p from row p on)
    return unflatten_frames(_diagonal_sum(F.pad(Y, (0, 0, 0, 0, 0, P - 1)), Y.shape, 1, 0), T)


def reconstruct(W, H, device=None):
    """V_hat from a 2-D basis (W @ H), a 3-D convolutive basis, or nmf2d's
    3-D H (k, n, P) (ReconstructFromDecomposition.m:30-38).  Accepts lists
    of per-source factors (cell-array semantics, RFD.m:23-28).  Tensors
    stay on their device; arrays go to ``device`` (default: the card)."""
    parts = [x for f in (W, H) for x in (f if isinstance(f, (list, tuple)) else [f])]
    first = next((x for x in parts if torch.is_tensor(x)), parts[0])
    device, dtype = resolve_device(first, device), resolve_dtype(first, None)

    def cat(f, dim):
        if isinstance(f, (list, tuple)):
            return torch.cat([as_tensor(x, dtype, device) for x in f], dim=dim)
        return as_tensor(f, dtype, device)

    W, H = cat(W, 1), cat(H, 0)
    if W.ndim == 2:
        return W @ H
    if H.ndim == 3:  # nmf2d factors: H carries a pitch axis (k, n, P)
        return conv_reconstruct_2d(W, H)
    return conv_reconstruct(W, H)
