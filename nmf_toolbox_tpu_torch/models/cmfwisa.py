"""Complex matrix factorization with intra-source additivity (King 2012).

PyTorch counterpart of ``nmf_toolbox_tpu/models/cmfwisa.py`` (reference:
cmfwisa.m): V ~ sum_i (W_i H_i) .* P_i with non-negative real W/H and
unit-modulus complex phases P_i.  V and P are complex tensors on the
device (complex64, or complex128 for f64 data); W, H and every GEMM stay
real, and the complex arithmetic is elementwise.

Kept from the reference:
* auxiliary ratios beta_i = (W_i H_i) / (W_all H_all) and per-source
  targets V_bar_i = V_hat_i + beta_i (V - V_hat) (cmfwisa.m:177-180);
* the phase update P_i = exp(1j angle(V_bar_i)) in angle form
  (cmfwisa.m:185): angle(0) = 0 gives P = 1 where V_bar vanishes, where
  V_bar / |V_bar| would give NaN;
* W/H multiplicative updates against the STALE full reconstruction
  (W_all/H_all rebuilt only after both updates — cmfwisa.m:192-205), the
  H denominator with the reference's (W_i' W_all) H_all association;
* cost = sum |V - V_hat|^2 + sum_i H_sparsity_i sum(H_i) (cmfwisa.m:
  214-217, no 0.5 factor);
* W_sparsity is accepted but unused, as in the reference.

The per-source reconstructions are one stacked (S, m, n) tensor carried
from one iteration to the next; the shared denominators are one
concatenated matmul sliced per source block.

Under a mesh (``parallel.placements_for("cmfwisa")``) V and the phases P
(S, m, n) shard like nmf's V, W's rows over features and H's columns
over samples.  Every cross-shard sum is real: G_i H', R H' over samples,
W'G_i, W_new'W and the column norms over features, the cost over every
rank; the pad of a padded problem pins the 0/0 beta and G to zero, as
in the JAX package.  Complex tensors cross ranks only in the final
gather of P, as real views.
"""
from __future__ import annotations

import torch

from ..core import (Result, as_list, as_tensor, common_scalars,
                    complex_dtype_of, merge_config, per_column, promote_inits,
                    promote_per_source, real_dtype_of, resolve_device,
                    resolve_dtype, source_blocks, staging_device, uniform_init,
                    unwrap_sources)
from ..ops import loop as looplib
from ..ops.masking import region_mask
from ..ops.normalize import unit_l2_columns
from ..parallel.collectives import gather_factor, sum_all, sum_features, sum_samples
from ..parallel.mesh import apply_placements, block_offset, check_mesh
from ..parallel.padding import pad_axes, plan_padding


def unit_phase(X):
    """exp(1j angle(X)) — the reference's phase of a complex field
    (cmfwisa.m:119,185); 1 where X is 0."""
    return torch.exp(1j * torch.angle(X)).to(X.dtype)


def per_source_wh(W, H, blocks):
    """(..., S, m, n): W_i @ H_i for each source block (H may carry a
    leading batch)."""
    return torch.stack([W[:, a:b] @ H[..., a:b, :] for a, b in blocks], dim=-3)


def complex_cost(V, WH, P, H, hsp):
    """sum |V - sum_i WH_i P_i|^2 + sum(hsp * row sums of H), per problem
    of a leading batch (cmfwisa.m:214-217)."""
    diff = V - torch.sum(WH * P, dim=-3)
    c = torch.sum(torch.real(diff * torch.conj(diff)), dim=(-2, -1))
    return c + torch.sum(hsp * torch.sum(H, dim=-1), dim=-1)


def phase_fields(V, WH, P, p_fixed, mask=None):
    """The auxiliary-variable fields of one iteration (cmfwisa.m:177-188):
    the new phases (frozen sources keep theirs) and G = |V_bar| / beta,
    from the stale per-source reconstructions WH (..., S, m, n).
    ``mask``: the valid region of a padded problem, where beta and G are
    kept; outside it they are 0/0 and pinned to zero."""
    V_hat = torch.sum(WH * P, dim=-3)
    R = torch.sum(WH, dim=-3, keepdim=True)  # stale W_all H_all (real)
    beta = WH / R                            # cmfwisa.m:178
    zero = torch.zeros((), dtype=beta.dtype, device=beta.device)
    if mask is not None:
        beta = torch.where(mask, beta, zero)
    V_bar = WH * P + beta * (V - V_hat)[..., None, :, :]  # cmfwisa.m:179
    P_new = unit_phase(V_bar)
    if any(p_fixed):
        P_new = torch.stack([P[..., s, :, :] if f else P_new[..., s, :, :]
                             for s, f in enumerate(p_fixed)], dim=-3)
    G = torch.abs(V_bar) / beta
    if mask is not None:
        G = torch.where(mask, G, zero)
    return P_new, G, R[..., 0, :, :]


def _sums(total, mesh, *xs):
    """``total(mesh, *xs)`` (a named sum of parallel/collectives) as a
    tuple, one tensor included."""
    out = total(mesh, *xs)
    return (out,) if len(xs) == 1 else out


def _make_step(V, blocks, w_fixed, h_fixed, p_fixed, hsp, eps, valid=None,
               mesh=None, h_sparse=True):
    offset = (block_offset(mesh, V.shape[0], "m"), block_offset(mesh, V.shape[1]))
    mask = region_mask(V.shape, valid, V.device, offset)

    def step(state, i):
        W, H, P, WH = state
        P, G, R = phase_fields(V, WH, P, p_fixed, mask)

        # W updates (cmfwisa.m:190-195); the denominators share R @ H'.
        free = [s for s in range(len(blocks)) if not w_fixed[s]]
        RHt, *GHt = _sums(sum_samples, mesh, R @ H.T,
                          *[G[s] @ H[a:b].T for s, (a, b) in enumerate(blocks) if s in free])
        cols = [W[:, a:b] for a, b in blocks]
        for s, num in zip(free, GHt):
            a, b = blocks[s]
            cols[s] = unit_l2_columns(W[:, a:b] * (num / torch.clamp_min(RHt[:, a:b], eps)),
                                      mesh)
        W_new = torch.cat(cols, dim=1)

        # H updates (cmfwisa.m:198-202): W_i is the UPDATED block, the
        # denominator (W_i' W_all) H_all uses the stale factors.
        free = [s for s in range(len(blocks)) if not h_fixed[s]]
        WtW, *WtG = _sums(sum_features, mesh, W_new.T @ W,
                          *[W_new[:, a:b].T @ G[s] for s, (a, b) in enumerate(blocks)
                            if s in free])
        M = WtW @ H
        rows = [H[a:b] for a, b in blocks]
        for s, num in zip(free, WtG):
            a, b = blocks[s]
            rows[s] = H[a:b] * (num / torch.clamp_min(M[a:b] + hsp[a:b, None], eps))
        H_new = torch.cat(rows, dim=0)

        WH_new = per_source_wh(W_new, H_new, blocks)
        if mesh is None:
            c = complex_cost(V, WH_new, P, H_new, hsp)
        else:
            # the residual's sum over every rank, H's row sums over samples
            c = sum_all(mesh, complex_cost(V, WH_new, P, H_new, 0.0))
            if h_sparse:
                c = c + torch.sum(hsp * sum_samples(mesh, torch.sum(H_new, dim=-1)))
        return (W_new, H_new, P, WH_new), c, False
    return step


def cmfwisa(V, num_basis_elems, config: dict | None = None, **kwargs):
    """Complex MF with intra-source additivity.  Returns (W, H, P, cost).

    Parameters (cmfwisa.m:10-80): W_init/H_init (real, per-source),
    P_init (complex unit-modulus, default exp(1j angle(V))), W_sparsity
    (accepted, unused — reference parity), H_sparsity, W_fixed / H_fixed
    / P_fixed (per source), maxiter (100), tolerance (1e-3), seed, dtype
    (complex64 / complex128; a real dtype picks its complex partner),
    eps, device, mesh (``parallel.make_mesh``: every rank calls with the
    same arguments and gets the whole factors and phases).  V is complex;
    a real V becomes complex (f64 -> complex128).  W, H and P are tensors
    on the run's device (P complex), per-source lists when given or asked
    for as lists.
    """
    cfg = merge_config(config, kwargs)
    mesh = check_mesh(cfg.get("mesh"))
    device = resolve_device(V, cfg.get("device"), mesh)
    cdt = complex_dtype_of(resolve_dtype(V, cfg.get("dtype")))
    rdt = real_dtype_of(cdt)
    src = staging_device(V, device, mesh)  # the whole arrays until placement
    V = as_tensor(V, cdt, src)
    m, n = V.shape

    ks, was_seq = as_list(num_basis_elems)
    ks = [int(k) for k in ks]
    S = len(ks)
    blocks = source_blocks(ks)
    h_sp = [max(float(v), 0.0) for v in
            promote_per_source(cfg.get("H_sparsity"), S, "H_sparsity", 0.0)]
    promote_per_source(cfg.get("W_sparsity"), S, "W_sparsity", 0.0)  # unused
    w_fx, h_fx, p_fx = (tuple(bool(x) for x in promote_per_source(
        cfg.get(key), S, key, False)) for key in ("W_fixed", "H_fixed", "P_fixed"))
    maxiter, tolerance, eps, gen = common_scalars(cfg)

    w_list, w_was_seq = promote_inits(cfg.get("W_init"), S, "basis")
    h_list, h_was_seq = promote_inits(cfg.get("H_init"), S, "encoding")
    p_list, p_was_seq = promote_inits(cfg.get("P_init"), S, "phase")
    if w_list is None:
        w_list = [unit_l2_columns(uniform_init(gen, (m, k), rdt, src)) for k in ks]
        w_was_seq = was_seq
    if h_list is None:
        h_list = [uniform_init(gen, (k, n), rdt, src) for k in ks]
        h_was_seq = was_seq
    if p_list is None:
        p_list = [unit_phase(V)] * S  # cmfwisa.m:119
        p_was_seq = was_seq

    W0 = unit_l2_columns(torch.cat([as_tensor(w, rdt, src) for w in w_list], dim=1))
    H0 = torch.cat([as_tensor(h, rdt, src) for h in h_list], dim=0)
    P0 = torch.stack([as_tensor(p, cdt, src) for p in p_list])
    hsp = per_column(h_sp, ks, rdt, device)

    pad_m, pad_n, valid = plan_padding(mesh, m, n)
    if valid is not None:
        V = pad_axes(V, {0: pad_m, 1: pad_n})
        W0 = pad_axes(W0, {0: pad_m})
        H0 = pad_axes(H0, {1: pad_n})
        P0 = pad_axes(P0, {1: pad_m, 2: pad_n})
    V, W0, H0, P0 = apply_placements(mesh, "cmfwisa", V=V, W=W0, H=H0, P=P0)

    out = looplib.run(_make_step(V, blocks, w_fx, h_fx, p_fx, hsp, eps, valid, mesh,
                                 any(h_sp)),
                      (W0, H0, P0, per_source_wh(W0, H0, blocks)), maxiter,
                      tolerance, cost_dtype=rdt)
    W, H, P, _ = out.state
    W = gather_factor(mesh, W, "m", 0)[:m]
    H = gather_factor(mesh, H, "n", 1)[:, :n]
    P = gather_factor(mesh, gather_factor(mesh, P, "m", 1), "n", 2)[:, :m, :n]
    return Result(
        fields=("W", "H", "P", "cost"),
        W=unwrap_sources(W, blocks, 1, w_was_seq),
        H=unwrap_sources(H, blocks, 0, h_was_seq),
        P=list(P) if p_was_seq else P[0],
        cost=looplib.trim_cost(out, maxiter),
        n_iters=int(out.n_iters), converged=bool(out.stopped),
    )
