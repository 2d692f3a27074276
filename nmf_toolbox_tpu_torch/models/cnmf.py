"""Convolutive NMF (Smaragdis 2007) with unified AB-divergence updates.

PyTorch counterpart of ``nmf_toolbox_tpu/models/cnmf.py`` (reference:
cnmf.m).  The reference's per-shift t-loops (cnmf.m:180-195, 216-227)
are GEMMs over the stacked shifts (ops/shift.py): the W gradient for all
T frames is one (m, n) @ (n, T*k) product, and the H gradient one
(T*k, m) @ (m, n) product followed by T shifts of (k, n) slabs, so no
(T, m, n) tensor is formed.

Multi-source cell arrays concatenate along the basis axis; every update
(including the diagonal normalization-correction terms and the
cross-frame renormalization of cnmf.m:161-165,196-199) is column-local,
so the loop has no per-source logic beyond the fixed-column masks.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import (Result, as_list, as_tensor, common_scalars,
                    fixed_col_mask, merge_config, parse_cost_every, per_column,
                    promote_inits, promote_per_source,
                    reject_mesh, resolve_device, resolve_dtype, source_blocks,
                    uniform_init, unwrap_sources)
from ..ops import divergence as dv
from ..ops import loop as looplib
from ..ops.gram import (conv_cross_grams_h, conv_cross_grams_w,
                        conv_euclidean_cost_gram, conv_wt_vhat_gram)
from ..ops.normalize import cross_frame_norm
from ..ops.shift import conv_phi_ht, conv_reconstruct, conv_wt_phi, stack_shifts_right
from ..parallel.padding import prepare_weights


def _keep_mask(fixed, ks, device):
    """Per-column bool tensor, True where the source's factor is frozen;
    None when no source is (the update then replaces the whole factor)."""
    if not any(fixed):
        return None
    return torch.as_tensor(fixed_col_mask(fixed, ks), device=device)


def _make_step(V, wsp, hsp, eps, div, a, b, T, method, w_fixed, h_fixed, ks,
               ce, maxiter, Mw=None):
    """One cnmf iteration, ``step(carry, i) -> (carry, cost, False)``."""
    w_keep, h_keep = _keep_mask(w_fixed, ks, V.device), _keep_mask(h_fixed, ks, V.device)
    w_any, h_any = not all(w_fixed), not all(h_fixed)
    finish = looplib.cost_cadence(ce, maxiter)
    n = V.shape[1]
    v_sq = torch.sum(V * V) if method == "gram" else None

    def penalty(W, H):
        return (torch.sum(wsp * torch.sum(torch.abs(W), dim=(0, 2)))
                + torch.sum(hsp * torch.sum(torch.abs(H), dim=1)))

    def update_w(W, Wn):
        Wn, _ = cross_frame_norm(Wn, None, T)  # cnmf.m:196-199
        return Wn if w_keep is None else torch.where(w_keep[None, :, None], W, Wn)

    def update_h(H, Hn):
        return Hn if h_keep is None else torch.where(h_keep[:, None], H, Hn)

    def gram_step(carry, i):
        # Euclidean only: the reconstruction is never formed.  Two GEMMs
        # touch V (conv_phi_ht(V, H) and conv_wt_phi(W, V)); the
        # reconstruction-dependent terms come from (T, T, k, k)
        # cross-Grams (cnmf.m:175-251, rearranged).
        W, H = carry[0], carry[1]
        if w_any:
            HH = conv_cross_grams_h(stack_shifts_right(H, T))  # HH[s, t] = Hs[s] Hs[t]'
            A = conv_phi_ht(V, H, T)                 # V @ Hs[t]'
            B = torch.einsum("mks,stkl->mlt", W, HH)  # V_hat @ Hs[t]'
            dneg = torch.sum(W * B, dim=0)
            dpos = torch.sum(W * A, dim=0)
            W = update_w(W, W * ((A + W * dneg[None]) / torch.clamp_min(
                B + W * dpos[None] + wsp[None, :, None], eps)))
        gneg = conv_wt_phi(W, V)
        WW = None
        if h_any:
            WW = conv_cross_grams_w(W)
            gpos = conv_wt_vhat_gram(WW, H)  # with the old H
            H = update_h(H, H * (gneg / torch.clamp_min(gpos + hsp[:, None], eps)))

        def cost_fn(W=W, H=H, gneg=gneg, WW=WW):
            # with the updated factors, in Gram space
            WW = conv_cross_grams_w(W) if WW is None else WW
            return conv_euclidean_cost_gram(v_sq, gneg, WW, H) + penalty(W, H)
        return finish((W, H), carry, i, cost_fn)

    # With per-entry weights the KL ones-field shortcuts do not apply: the
    # positive field is the weight matrix and is shifted like any other
    # field (the paper-correct form; the reference's no-shift quirk at
    # cnmf.m:220-224 belongs to the position-independent ones field only).
    kl_fast = div == "kl" and Mw is None

    def naive_step(carry, i):
        W, H = carry[0], carry[1]  # W (m, k, T), H (k, n)
        if w_any:
            phi_neg, phi_pos, power = dv.ab_fields(V, conv_reconstruct(W, H), a, b,
                                                   weights=Mw)
            A = conv_phi_ht(phi_neg, H, T)
            if kl_fast:
                # ones(m, n) @ shift_right(H, t)' is a broadcast of the
                # shifted row sums sum(H[:, :n-t]): the cumsum at n-1-t.
                rs = torch.cumsum(H, dim=1)[:, n - T:].flip(1)  # (k, T)
                B = rs[None]
                dneg = torch.sum(W, dim=0) * rs
            else:
                B = conv_phi_ht(phi_pos, H, T)
                dneg = torch.sum(W * B, dim=0)  # diag(Hs Phi_pos' W_t), (k, T)
            dpos = torch.sum(W * A, dim=0)
            neg = dv.apply_power(A + W * dneg[None], power)
            pos = dv.apply_power(B + W * dpos[None], power)
            W = update_w(W, W * (neg / torch.clamp_min(pos + wsp[None, :, None], eps)))
        if h_any:
            phi_neg, phi_pos, power = dv.ab_fields(V, conv_reconstruct(W, H), a, b,
                                                   weights=Mw)
            gneg = dv.apply_power(conv_wt_phi(W, phi_neg), power)
            if kl_fast:
                # KL: the positive field is NOT shifted (cnmf.m:220-224), and
                # sum_t W_t' @ ones(m, n) is a broadcast of sum(W) over (m, t).
                gpos = torch.sum(W, dim=(0, 2))[:, None]
            else:
                gpos = dv.apply_power(conv_wt_phi(W, phi_pos), power)
            H = update_h(H, H * (gneg / torch.clamp_min(gpos + hsp[:, None], eps)))

        def cost_fn(W=W, H=H):
            # the objective's own reconstruction, dropped on the skipped
            # iterations of cost_every > 1
            return (dv.cost(div, V, conv_reconstruct(W, H), a, b, weights=Mw)
                    + penalty(W, H))
        return finish((W, H), carry, i, cost_fn)

    return gram_step if method == "gram" else naive_step


def cnmf(V, num_basis_elems, context_len: int, config: dict | None = None,
         **kwargs):
    """Convolutive NMF: V ~ sum_t W[:, :, t] @ shift_right(H, t).

    Parameters (cnmf.m:17-80): divergence/alpha/beta (euclidean, kl and
    is map onto AB (alpha, beta), cnmf.m:137-147; alpha = beta = 0 is
    rejected), W_init (m, k, T), H_init (k, n), W_sparsity/H_sparsity,
    W_fixed/H_fixed (each scalar or per source), maxiter (100), tolerance
    (1e-3).  ``num_basis_elems`` may be a list (one entry per source; the
    factors come back as per-source lists).  Extras: dtype, seed, eps,
    ``weights`` ((m, n) nonnegative per-entry weights; forces
    ``method='naive'``), ``method`` ('auto': 'gram' for euclidean, else
    'naive'; 'gram' is euclidean only), ``cost_every`` (evaluate the
    objective every N iterations; the factors are bit-identical, the stop
    rule checks N-iteration windows, ops/loop.cost_cadence), ``device``
    (where a NumPy ``V`` goes; default the CUDA card).  ``mesh`` raises
    ``NotImplementedError``.

    KL: the weighted solver uses the paper-correct SHIFTED positive field,
    whereas the unweighted KL path reproduces the reference's no-shift
    boundary quirk (cnmf.m:220-224), so ``weights=ones`` matches the
    unweighted run exactly for euclidean/IS/AB but differs near the right
    time boundary for KL.  The entry cross-frame normalization
    (cnmf.m:157-166) moves each basis element's norm into H.  Returns a
    :class:`Result` (W, H, cost) with tensors on the run's device.
    """
    cfg = merge_config(config, kwargs)
    reject_mesh(cfg)
    device = resolve_device(V, cfg.get("device"))
    dtype = resolve_dtype(V, cfg.get("dtype"))
    V = as_tensor(V, dtype, device)
    m, n = V.shape
    T = int(context_len)

    ks, was_seq = as_list(num_basis_elems)
    ks = [int(k) for k in ks]
    S = len(ks)
    blocks = source_blocks(ks)

    div = dv.canon(cfg.get("divergence", "euclidean"))
    alpha, beta = dv.ab_params(div, cfg.get("alpha", 1.0), cfg.get("beta", 1.0))
    if div == "ab" and alpha == 0.0 and beta == 0.0:
        raise ValueError("alpha = 0 and beta = 0 is not supported at this time.")

    w_sp = [max(float(v), 0.0) for v in
            promote_per_source(cfg.get("W_sparsity"), S, "W_sparsity", 0.0)]
    h_sp = [max(float(v), 0.0) for v in
            promote_per_source(cfg.get("H_sparsity"), S, "H_sparsity", 0.0)]
    w_fx = [bool(x) for x in promote_per_source(cfg.get("W_fixed"), S, "W_fixed", False)]
    h_fx = [bool(x) for x in promote_per_source(cfg.get("H_fixed"), S, "H_fixed", False)]
    maxiter, tolerance, eps, gen = common_scalars(cfg)

    w_list, w_was_seq = promote_inits(cfg.get("W_init"), S, "basis")
    h_list, h_was_seq = promote_inits(cfg.get("H_init"), S, "encoding")
    if w_list is None:
        # rand (m, k, T) with per-frame unit-L2 columns (ValidateParameters.m:82-88)
        w_list = [uniform_init(gen, (m, k, T), dtype, device) for k in ks]
        w_list = [w / torch.sqrt(torch.sum(w * w, dim=0, keepdim=True)) for w in w_list]
        w_was_seq = was_seq
    if h_list is None:
        h_list = [uniform_init(gen, (k, n), dtype, device) for k in ks]
        h_was_seq = was_seq
    for s, (w, h, k) in enumerate(zip(w_list, h_list, ks)):
        if np.shape(w) != (m, k, T):
            raise ValueError(f"W_init[{s}] has shape {tuple(np.shape(w))}, expected {(m, k, T)}")
        if np.shape(h) != (k, n):
            raise ValueError(f"H_init[{s}] has shape {tuple(np.shape(h))}, expected {(k, n)}")
    W0 = torch.cat([as_tensor(w, dtype, device) for w in w_list], dim=1)
    H0 = torch.cat([as_tensor(h, dtype, device) for h in h_list], dim=0)
    W0, H0 = cross_frame_norm(W0, H0, T)  # cnmf.m:157-166

    weights = cfg.get("weights")
    if weights is not None:
        weights = prepare_weights(weights, dtype, (m, n), None, "cnmf",
                                  0, 0, None, device=device)
    method = cfg.get("method", "auto")
    euclid = div == "euclidean" and alpha == 1.0 and beta == 1.0
    if weights is not None:
        # weighted fields need the materialized reconstruction
        if method == "auto":
            method = "naive"
        elif method != "naive":
            raise ValueError("weights= requires method='naive' (the weighted "
                             "fields are nonlinear in the reconstruction)")
    if method == "auto":
        method = "gram" if euclid else "naive"
    if method == "gram" and not euclid:
        raise ValueError("method='gram' is only valid for the euclidean divergence")

    ce = parse_cost_every(cfg)
    with torch.no_grad():
        step = _make_step(V, per_column(w_sp, ks, dtype, device),
                          per_column(h_sp, ks, dtype, device), eps, div, alpha, beta,
                          T, method, w_fx, h_fx, ks, ce, maxiter, weights)
        out = looplib.run(step, looplib.cadence_state((W0, H0), ce, dtype),
                          maxiter, tolerance, cost_dtype=dtype, cost_every=ce)
    W, H = out.state[0], out.state[1]
    return Result(fields=("W", "H", "cost"),
                  W=unwrap_sources(W, blocks, 1, w_was_seq),
                  H=unwrap_sources(H, blocks, 0, h_was_seq),
                  cost=looplib.trim_cost(out, maxiter),
                  n_iters=out.n_iters, converged=out.stopped)
