"""Hoyer's L1/L2 sparsity projection, on many vectors at once.

PyTorch counterpart of ``nmf_toolbox_tpu/ops/projection.py``.  Solves,
for each vector s: find v minimizing ||v - s||_2 subject to sum(v) = k1,
sum(v^2) = k2, v >= 0 (projfunc.m, Hoyer 2004).

The reference projects one vector at a time with a data-dependent loop
(each pass zeroes at least one more coefficient, so it ends within N
passes).  Here all vectors are projected together, each frozen once it
is done, and the loop stops when every vector is done or after N + 1
passes, the JAX package's rule.  On a card that loop is one launch of
the hand-written kernel of ``ops/kernels/hoyer.py``, which reads nothing
back.  Elsewhere it runs here: a pass over a frozen vector is an exact
no-op, so the loop runs its passes in groups and reads "all done" on the
host once per group, bit-identical to reading after every pass.

The vectors lie along the LAST axis (:func:`project_rows`); leading
axes are batch, which is how a line search projects all its candidates
in one call.  :func:`project_columns` is the JAX package's (N, B) form.

:func:`project_rows_bounded` is the phased nmfsc dispatch's form: a
fixed pass budget, no host read, and on a CUDA tensor one launch of the
hand-written kernel of ``ops/kernels/hoyer.py``.
"""
from __future__ import annotations

import math

import torch

from ..core import as_tensor, host_read, resolve_device, resolve_dtype
from ..parallel.collectives import sum_axis
from ..parallel.mesh import block_offset
from .kernels import hoyer

PASSES_PER_READ = 4  # projection passes between two reads of "all done"


def project_rows(S, k1, k2, valid: int | None = None, mesh=None, axis=None):
    """Project every vector S[..., :] (length N, the last axis) onto
    {sum = k1, sum of squares = k2, >= 0}.

    k1/k2 are scalars or tensors broadcasting against S.shape[:-1].
    Returns (V, iters), iters the per-vector pass count (projfunc.m
    ``usediters``, int32).  ``valid`` handles padded vectors: only the
    first ``valid`` entries form the true vector; the pad enters the
    loop pre-zeroed, so every sum divides by the true length.

    ``mesh``: the vectors' last axis is sharded over the mesh axis
    ``axis`` and S holds this rank's entries; every per-vector sum (the
    L1 and L2 sums, the count of zeroed entries, the midpoint's norm, the
    count of negative entries) goes through that axis' sum, ``valid``
    counts global entries, and every rank reads the same "all done".

    A CUDA tensor whose vectors are whole on this rank (no mesh, or one
    rank on ``axis``) is projected by one launch of the kernel of
    ``ops/kernels/hoyer.py`` with a budget of N + 1 passes, reading
    nothing back.  CPU tensors, and vectors sharded over two or more
    ranks (whose sums need collectives), run the passes here, reading
    "all done" once per group of ``PASSES_PER_READ``.
    """
    if mesh is not None and axis is None:
        raise ValueError("project_rows: a mesh needs the axis its vectors are sharded over")
    n_loc = S.shape[-1]
    N = n_loc * (1 if mesh is None else mesh.size(axis))
    if S.device.type == "cuda" and N == n_loc:
        # nmf_toolbox_tpu/ops/projection.py's while_loop (:55-58,89) as one
        # launch: N + 1 passes at most, each vector stopping once done.
        v, _, iters = hoyer.hoyer_project(S, k1, k2, N + 1, valid)
        return v, iters

    def total(*xs):  # per-vector sums over every rank's entries
        return sum_axis(mesh, axis, *xs)

    v, zero, nz, k1, k2 = start(S, k1, k2, valid, N, block_offset(mesh, n_loc, axis), total)
    zero_t = torch.zeros((), dtype=S.dtype, device=S.device)
    done = torch.zeros(v.shape[:-1], dtype=torch.bool, device=S.device)
    iters = torch.zeros(v.shape[:-1], dtype=torch.int32, device=S.device)

    group = PASSES_PER_READ
    j = 0
    while j < N + 1:
        for _ in range(min(group, N + 1 - j)):
            v, zero, nz, done, iters = _pass(v, zero, nz, done, iters, k1, k2, N,
                                             zero_t, total)
        j += group
        if host_read(torch.all(done)):
            break
    return v, iters


def project_rows_bounded(S, k1, k2, passes: int):
    """Project every vector S[..., :] in at most ``min(passes, N + 1)``
    passes, each vector frozen once it is done, reading nothing back.

    The counterpart of the JAX package's ``_project_columns_bounded``
    (models/nmfsc_phased.py:70-113) in :func:`project_rows`'s layout,
    with the port's own pass (its cancellation-free root included).
    Single-device: no ``valid``, no mesh.  k1 and k2 are Python scalars.
    Returns (V, done), ``done`` each vector's flag.  When ``passes``
    covers the pass count, V equals :func:`project_rows`'s bit for bit
    on the CPU.  A CUDA tensor launches ``csrc/hoyer.cu`` or raises.
    """
    v, done, _ = hoyer.hoyer_project(S, k1, k2, passes)
    return v, done


def local_sums(*xs):
    """:func:`~nmf_toolbox_tpu_torch.parallel.collectives.sum_axis` with
    no mesh: the sums as they are."""
    return xs[0] if len(xs) == 1 else xs


def start(S, k1, k2, valid, N, offset=0, total=local_sums):
    """The state before the first pass: ``(v, zero, nz, k1, k2)``, v on
    the sum hyperplane (projfunc.m:22), the zero mask, each vector's count
    of zeroed entries and the targets broadcast over the batch.  Entries
    at or past ``valid`` (global index: this rank's block starts at
    ``offset``) start zeroed and the step divides by ``valid``; ``total``
    sums per vector over every rank's entries."""
    dt, dev = S.dtype, S.device
    batch = S.shape[:-1]
    k1 = torch.as_tensor(k1, dtype=dt, device=dev).expand(batch)
    k2 = torch.as_tensor(k2, dtype=dt, device=dev).expand(batch)
    if valid is None or valid >= N:
        v = S + ((k1 - total(torch.sum(S, dim=-1))) / N)[..., None]
        zero = torch.zeros(S.shape, dtype=torch.bool, device=dev)
        nz = torch.zeros(batch, dtype=dt, device=dev)
    else:
        zero_t = torch.zeros((), dtype=dt, device=dev)
        pad = torch.arange(offset, offset + S.shape[-1], device=dev) >= valid
        Sm = torch.where(pad, zero_t, S)
        v = torch.where(pad, zero_t,
                        Sm + ((k1 - total(torch.sum(Sm, dim=-1))) / valid)[..., None])
        zero = pad.expand(S.shape)
        nz = torch.full(batch, float(N - valid), dtype=dt, device=dev)
    return v, zero, nz, k1, k2


def _pass(v, zero, nz, done, iters, k1, k2, N, zero_t, total):
    """One projection pass (projfunc.m:28-55); frozen vectors unchanged.
    ``nz`` counts each vector's zeroed entries; ``total`` sums per vector
    over every rank's entries, in two collectives per pass under a mesh."""
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
    a, s, mm = total(torch.sum(w * w, dim=-1), torch.sum(w * midpoint, dim=-1),
                     torch.sum(midpoint * midpoint, dim=-1))
    q = k2 - mm
    disc = torch.clamp_min(s * s + a * q, 0.0)
    beta = (-s + torch.sqrt(disc)) / a
    v_proj = beta[..., None] * w + midpoint

    # Zero-clamp and redistribute for the still-negative vectors
    # (projfunc.m:49-53); a vector is done when none of its entries is
    # negative (projfunc.m:40-44).
    zero_new = zero | (v_proj <= 0)
    v_cl = torch.where(zero_new, zero_t, v_proj)
    n_neg, nz2, s_cl = total(torch.sum(~(v_proj >= 0), dim=-1, dtype=v.dtype),
                             torch.sum(zero_new, dim=-1, dtype=v.dtype),
                             torch.sum(v_cl, dim=-1))
    ok = n_neg == 0
    v_re = v_cl + ((k1 - s_cl) / (N - nz2))[..., None]
    v_re = torch.where(zero_new, zero_t, v_re)

    keep = done | ok
    v_next = torch.where(done[..., None], v,
                         torch.where(ok[..., None], v_proj, v_re))
    zero_next = torch.where(keep[..., None], zero, zero_new)
    nz_next = torch.where(keep, nz, nz2)
    iters_next = torch.where(done, iters, iters + 1)
    return v_next, zero_next, nz_next, keep, iters_next


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
