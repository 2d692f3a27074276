"""Hoyer's L1/L2 sparsity projection, on many vectors at once.

PyTorch counterpart of ``nmf_toolbox_tpu/ops/projection.py``.  Solves,
for each vector s: find v minimizing ||v - s||_2 subject to sum(v) = k1,
sum(v^2) = k2, v >= 0 (projfunc.m, Hoyer 2004).

The reference projects one vector at a time with a data-dependent loop
(each pass zeroes at least one more coefficient, so it ends within N
passes).  Here all vectors are projected together, each frozen once it
is done, and the loop stops when every vector is done or after N + 1
passes, the JAX package's rule.  A pass over a frozen vector is an exact
no-op, so the loop runs its passes in groups and reads "all done" on the
host once per group: the result is bit-identical to reading after every
pass.

The vectors lie along the LAST axis (:func:`project_rows`); leading
axes are batch, which is how a line search projects all its candidates
in one call.  :func:`project_columns` is the JAX package's (N, B) form.
"""
from __future__ import annotations

import math

import torch

from ..core import as_tensor, host_read, resolve_device, resolve_dtype

PASSES_PER_READ = 4  # projection passes between two reads of "all done"


def project_rows(S, k1, k2, valid: int | None = None):
    """Project every vector S[..., :] (length N, the last axis) onto
    {sum = k1, sum of squares = k2, >= 0}.

    k1/k2 are scalars or tensors broadcasting against S.shape[:-1].
    Returns (V, iters), iters the per-vector pass count (projfunc.m
    ``usediters``, int32).  ``valid`` handles padded vectors: only the
    first ``valid`` entries form the true vector; the pad enters the
    loop pre-zeroed, so every sum divides by the true length.
    """
    N = S.shape[-1]
    dt, dev = S.dtype, S.device
    batch = S.shape[:-1]
    k1 = torch.as_tensor(k1, dtype=dt, device=dev).expand(batch)
    k2 = torch.as_tensor(k2, dtype=dt, device=dev).expand(batch)
    zero_t = torch.zeros((), dtype=dt, device=dev)

    if valid is None or valid >= N:
        # Initial projection onto the sum hyperplane (projfunc.m:22).
        v = S + ((k1 - torch.sum(S, dim=-1)) / N)[..., None]
        zero = torch.zeros(S.shape, dtype=torch.bool, device=dev)
    else:
        pad = torch.arange(N, device=dev) >= valid
        Sm = torch.where(pad, zero_t, S)
        v = torch.where(pad, zero_t,
                        Sm + ((k1 - torch.sum(Sm, dim=-1)) / valid)[..., None])
        zero = pad.expand(S.shape)
    done = torch.zeros(batch, dtype=torch.bool, device=dev)
    iters = torch.zeros(batch, dtype=torch.int32, device=dev)

    group = PASSES_PER_READ
    j = 0
    while j < N + 1:
        for _ in range(min(group, N + 1 - j)):
            v, zero, done, iters = _pass(v, zero, done, iters, k1, k2, N, zero_t)
        j += group
        if host_read(torch.all(done)):
            break
    return v, iters


def _pass(v, zero, done, iters, k1, k2, N, zero_t):
    """One projection pass (projfunc.m:28-55); frozen vectors unchanged."""
    nz = torch.sum(zero, dim=-1)
    # Projection to the L2 sphere along the hyperplane (projfunc.m:31-38):
    # v + alpha w with ||v + alpha w||^2 = k2, w = v - midpoint.  With
    # v = midpoint + w, b = 2(a + s) and c = a + 2s + ||midpoint||^2 - k2
    # (s = <w, midpoint>), so b^2 - 4ac = 4(s^2 + a q), q = k2 -
    # ||midpoint||^2, and v + alpha w = midpoint + beta w with
    # beta = 1 + alpha = (-s + sqrt(s^2 + a q)) / a.  The reference's
    # b^2 - 4ac cancels: in f32 it is rounding noise once a exceeds ~1e7 k2
    # (a line search's first trials), and the clamp then returns the
    # hyperplane's centre; this form keeps the clamp (MATLAB's
    # real(sqrt(negative)) = 0) without the cancellation.
    midpoint = torch.where(zero, zero_t, (k1 / (N - nz))[..., None])
    w = v - midpoint
    a = torch.sum(w * w, dim=-1)
    s = torch.sum(w * midpoint, dim=-1)
    q = k2 - torch.sum(midpoint * midpoint, dim=-1)
    disc = torch.clamp_min(s * s + a * q, 0.0)
    beta = (-s + torch.sqrt(disc)) / a
    v_proj = beta[..., None] * w + midpoint

    ok = torch.all(v_proj >= 0, dim=-1)  # projfunc.m:40-44

    # Zero-clamp and redistribute for the still-negative vectors
    # (projfunc.m:49-53).
    zero_new = zero | (v_proj <= 0)
    nz2 = torch.sum(zero_new, dim=-1)
    v_cl = torch.where(zero_new, zero_t, v_proj)
    v_re = v_cl + ((k1 - torch.sum(v_cl, dim=-1)) / (N - nz2))[..., None]
    v_re = torch.where(zero_new, zero_t, v_re)

    v_next = torch.where(done[..., None], v,
                         torch.where(ok[..., None], v_proj, v_re))
    zero_next = torch.where((done | ok)[..., None], zero, zero_new)
    iters_next = torch.where(done, iters, iters + 1)
    return v_next, zero_next, done | ok, iters_next


def project_columns(S, k1, k2, valid: int | None = None):
    """Project every column of S (N, B) onto {sum=k1, sum of squares=k2,
    >=0}: :func:`project_rows` of S's transpose (a view).  k1/k2 are
    scalars or per-column (B,) tensors.  Returns (V (N, B), iters (B,))."""
    v, iters = project_rows(S.mT, k1, k2, valid)
    return v.mT, iters


def projfunc(s, k1, k2, nonneg: bool = True, device=None):
    """Single-vector API matching the reference signature (projfunc.m:1).

    When ``nonneg`` is False, signs are recorded, the projection runs on
    |s|, and signs are restored (projfunc.m:15-19, 57-60).  A tensor
    stays on its device; an array goes to ``device`` (default: the
    card).  Returns (v of s's shape, iters as a 0-d tensor).
    """
    s = as_tensor(s, resolve_dtype(s, None), resolve_device(s, device))
    flat = s.reshape(-1)
    if nonneg:
        v, iters = project_rows(flat, k1, k2)
        return v.reshape(s.shape), iters
    signs = torch.where(flat < 0, -1.0, 1.0).to(flat.dtype)
    v, iters = project_rows(torch.abs(flat), k1, k2)
    return (signs * v).reshape(s.shape), iters


def hoyer_l1_target(dim: int, sparseness: float) -> float:
    """L1 target for unit-L2 vectors at a given Hoyer sparseness in [0, 1].

    Reference: nmfsc.m:93,106 — sqrt(d) - (sqrt(d) - 1) * s.
    """
    return math.sqrt(dim) - (math.sqrt(dim) - 1.0) * sparseness
