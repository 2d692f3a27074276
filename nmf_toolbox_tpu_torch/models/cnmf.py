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
                    promote_inits, promote_per_source, resolve_device,
                    resolve_dtype, source_blocks, staging_device,
                    uniform_init, unwrap_sources)
from ..ops import divergence as dv
from ..ops import loop as looplib
from ..ops.gram import (conv_cross_grams_h, conv_cross_grams_w,
                        conv_euclidean_cost_gram, conv_wt_vhat_gram)
from ..ops.masking import region_mask
from ..ops.normalize import cross_frame_norm
from ..ops.shift import (conv_reconstruct, conv_wt_phi, phi_ht, shifted_row_sums,
                         stack_shifts_right)
from ..parallel.collectives import gather_factor, sum_all, sum_features, sum_samples
from ..parallel.mesh import apply_placements, block_offset, check_mesh
from ..parallel.padding import pad_axes, plan_padding, prepare_weights


def _keep_mask(fixed, ks, device):
    """Per-column bool tensor, True where the source's factor is frozen;
    None when no source is (the update then replaces the whole factor)."""
    if not any(fixed):
        return None
    return torch.as_tensor(fixed_col_mask(fixed, ks), device=device)


def _make_step(V, wsp, hsp, eps, div, a, b, T, method, w_fixed, h_fixed, ks,
               ce, maxiter, Mw=None, valid=None, mesh=None, sparse=(True, True)):
    """One cnmf iteration, ``step(carry, i) -> (carry, cost, False)``.

    Under a ``mesh`` V, W's rows and H's columns are this rank's blocks
    (``parallel.placements_for("cnmf")``).  H's shift stack reads the
    T - 1 columns before the block and every left shift the T - 1 after
    it (``parallel.collectives.halo``); the products over samples (V Hs',
    the cross-Grams of H) and over features (W'V, the cross-Grams of W,
    the cross-frame norms) sum explicitly, and the cost over every rank.
    ``sparse``: whether any W / H sparsity penalty enters the cost."""
    w_keep, h_keep = _keep_mask(w_fixed, ks, V.device), _keep_mask(h_fixed, ks, V.device)
    w_any, h_any = not all(w_fixed), not all(h_fixed)
    finish = looplib.cost_cadence(ce, maxiter)
    n = V.shape[1]
    c0 = block_offset(mesh, n)
    nv = None if valid is None else valid[1]
    mask = region_mask(V.shape, valid, V.device, (block_offset(mesh, V.shape[0], "m"), c0))
    v_sq = sum_all(mesh, torch.sum(V * V)) if method == "gram" else None

    def stack(H):
        return stack_shifts_right(H, T, nv, mesh)

    def penalty(W, H):
        pw = torch.sum(torch.abs(W), dim=(0, 2))
        ph = torch.sum(torch.abs(H), dim=1)
        if mesh is not None:
            pw = sum_features(mesh, pw) if sparse[0] else pw
            ph = sum_samples(mesh, ph) if sparse[1] else ph
        return torch.sum(wsp * pw) + torch.sum(hsp * ph)

    def update_w(W, Wn):
        Wn, _ = cross_frame_norm(Wn, None, T, mesh=mesh)  # cnmf.m:196-199
        return Wn if w_keep is None else torch.where(w_keep[None, :, None], W, Wn)

    def update_h(H, Hn):
        return Hn if h_keep is None else torch.where(h_keep[:, None], H, Hn)

    def gram_step(carry, i):
        # Euclidean only: the reconstruction is never formed.  Two GEMMs
        # touch V (V Hs' and W'V); the reconstruction-dependent terms
        # come from (T, T, k, k) cross-Grams (cnmf.m:175-251, rearranged).
        W, H = carry[0], carry[1]
        Hs = None
        if w_any:
            Hs = stack(H)
            HH, A = sum_samples(mesh, conv_cross_grams_h(Hs),  # HH[s, t] = Hs[s] Hs[t]'
                                phi_ht(V, Hs))                # V @ Hs[t]'
            B = torch.einsum("mks,stkl->mlt", W, HH)  # V_hat @ Hs[t]'
            dneg, dpos = sum_features(mesh, torch.sum(W * B, dim=0),
                                      torch.sum(W * A, dim=0))
            W = update_w(W, W * ((A + W * dneg[None]) / torch.clamp_min(
                B + W * dpos[None] + wsp[None, :, None], eps)))
        WW = None
        if h_any:
            gneg, WW = sum_features(mesh, conv_wt_phi(W, V, mesh), conv_cross_grams_w(W))
            gpos = conv_wt_vhat_gram(WW, H, mesh, stack(H) if Hs is None else Hs)  # old H
            H = update_h(H, H * (gneg / torch.clamp_min(gpos + hsp[:, None], eps)))
        else:
            gneg = sum_features(mesh, conv_wt_phi(W, V, mesh))

        def cost_fn(W=W, H=H, gneg=gneg, WW=WW):
            # with the updated factors, in Gram space
            WW = sum_features(mesh, conv_cross_grams_w(W)) if WW is None else WW
            return (conv_euclidean_cost_gram(v_sq, gneg, WW, H, nv, mesh)
                    + penalty(W, H))
        return finish((W, H), carry, i, cost_fn)

    # With per-entry weights the KL ones-field shortcuts do not apply: the
    # positive field is the weight matrix and is shifted like any other
    # field (the paper-correct form; the reference's no-shift quirk at
    # cnmf.m:220-224 belongs to the position-independent ones field only).
    kl_fast = div == "kl" and Mw is None
    n_true = n * (1 if mesh is None else mesh.size("n")) if nv is None else nv

    def naive_step(carry, i):
        W, H = carry[0], carry[1]  # W (m, k, T), H (k, n)
        Hs = stack(H)  # H's shifts serve both updates' reconstructions
        if w_any:
            phi_neg, phi_pos, power = dv.ab_fields(V, conv_reconstruct(W, H, Hs=Hs), a, b,
                                                   mask=mask, weights=Mw)
            if kl_fast:
                # ones(m, n) @ shift_right(H, t)' is a broadcast of the
                # shifted row sums sum(H[:, :n-t]).
                A, rs = sum_samples(mesh, phi_ht(phi_neg, Hs),
                                    shifted_row_sums(H, T, n_true, c0))  # rs (k, T)
                B = rs[None]
                w_sum, dpos = sum_features(mesh, torch.sum(W, dim=0),
                                           torch.sum(W * A, dim=0))
                dneg = w_sum * rs
            else:
                A, B = sum_samples(mesh, phi_ht(phi_neg, Hs), phi_ht(phi_pos, Hs))
                dneg, dpos = sum_features(mesh, torch.sum(W * B, dim=0),  # (k, T)
                                          torch.sum(W * A, dim=0))
            neg = dv.apply_power(A + W * dneg[None], power)
            pos = dv.apply_power(B + W * dpos[None], power)
            W = update_w(W, W * (neg / torch.clamp_min(pos + wsp[None, :, None], eps)))
        if h_any:
            phi_neg, phi_pos, power = dv.ab_fields(V, conv_reconstruct(W, H, Hs=Hs), a, b,
                                                   mask=mask, weights=Mw)
            if kl_fast:
                # KL: the positive field is NOT shifted (cnmf.m:220-224), and
                # sum_t W_t' @ ones(m, n) is a broadcast of sum(W) over (m, t).
                gneg, w_sum = sum_features(mesh, conv_wt_phi(W, phi_neg, mesh),
                                           torch.sum(W, dim=(0, 2)))
                gneg = dv.apply_power(gneg, power)
                gpos = w_sum[:, None]
            else:
                gneg, gpos = sum_features(mesh, conv_wt_phi(W, phi_neg, mesh),
                                          conv_wt_phi(W, phi_pos, mesh))
                gneg = dv.apply_power(gneg, power)
                gpos = dv.apply_power(gpos, power)
            H = update_h(H, H * (gneg / torch.clamp_min(gpos + hsp[:, None], eps)))

        def cost_fn(W=W, H=H):
            # the objective's own reconstruction, dropped on the skipped
            # iterations of cost_every > 1
            return (dv.cost(div, V, conv_reconstruct(W, H, nv, mesh), a, b, mask=mask,
                            weights=Mw, mesh=mesh)
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
    (where a NumPy ``V`` goes; default the CUDA card), ``mesh``
    (``parallel.make_mesh``: every rank calls with the same arguments; V
    is zero-padded to the mesh's multiples, each rank runs its block with
    the T - 1 columns of context of its neighbours, and every rank gets
    the whole W and H).

    KL: the weighted solver uses the paper-correct SHIFTED positive field,
    whereas the unweighted KL path reproduces the reference's no-shift
    boundary quirk (cnmf.m:220-224), so ``weights=ones`` matches the
    unweighted run exactly for euclidean/IS/AB but differs near the right
    time boundary for KL.  The entry cross-frame normalization
    (cnmf.m:157-166) moves each basis element's norm into H.  Returns a
    :class:`Result` (W, H, cost) with tensors on the run's device.
    """
    cfg = merge_config(config, kwargs)
    mesh = check_mesh(cfg.get("mesh"))
    device = resolve_device(V, cfg.get("device"), mesh)
    dtype = resolve_dtype(V, cfg.get("dtype"))
    src = staging_device(V, device, mesh)  # the whole arrays until placement
    V = as_tensor(V, dtype, src)
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
        w_list = [uniform_init(gen, (m, k, T), dtype, src) for k in ks]
        w_list = [w / torch.sqrt(torch.sum(w * w, dim=0, keepdim=True)) for w in w_list]
        w_was_seq = was_seq
    if h_list is None:
        h_list = [uniform_init(gen, (k, n), dtype, src) for k in ks]
        h_was_seq = was_seq
    for s, (w, h, k) in enumerate(zip(w_list, h_list, ks)):
        if np.shape(w) != (m, k, T):
            raise ValueError(f"W_init[{s}] has shape {tuple(np.shape(w))}, expected {(m, k, T)}")
        if np.shape(h) != (k, n):
            raise ValueError(f"H_init[{s}] has shape {tuple(np.shape(h))}, expected {(k, n)}")
    W0 = torch.cat([as_tensor(w, dtype, src) for w in w_list], dim=1)
    H0 = torch.cat([as_tensor(h, dtype, src) for h in h_list], dim=0)
    W0, H0 = cross_frame_norm(W0, H0, T)  # cnmf.m:157-166

    pad_m, pad_n, valid = plan_padding(mesh, m, n)
    if valid is not None:
        V = pad_axes(V, {0: pad_m, 1: pad_n})
        W0 = pad_axes(W0, {0: pad_m})
        H0 = pad_axes(H0, {1: pad_n})
    V, W0, H0 = apply_placements(mesh, "cnmf", V=V, W=W0, H=H0)
    weights = prepare_weights(cfg.get("weights"), dtype, (m, n), mesh, "cnmf",
                              pad_m, pad_n, valid, device=device)
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
                          T, method, w_fx, h_fx, ks, ce, maxiter, weights, valid,
                          mesh, (any(w_sp), any(h_sp)))
        out = looplib.run(step, looplib.cadence_state((W0, H0), ce, dtype),
                          maxiter, tolerance, cost_dtype=dtype, cost_every=ce)
    W = gather_factor(mesh, out.state[0], "m", 0)[:m]
    H = gather_factor(mesh, out.state[1], "n", 1)[:, :n]
    return Result(fields=("W", "H", "cost"),
                  W=unwrap_sources(W, blocks, 1, w_was_seq),
                  H=unwrap_sources(H, blocks, 0, h_was_seq),
                  cost=looplib.trim_cost(out, maxiter),
                  n_iters=out.n_iters, converged=out.stopped)
