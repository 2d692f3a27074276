"""Convex-hull NMF (Thurau et al. 2011): V ~ S G H, S = hull anchors of V.

PyTorch counterpart of ``nmf_toolbox_tpu/models/chnmf.py`` (reference:
chnmf.m).  The one-time init (covariance eigenvectors and per-pair 2-D
convex hulls, chnmf.m:85-106) is ``utils/init.convex_hull_anchors``.
The Grams S'V and S'S are formed once, before the loop, so the loop
touches only p-by-n and k-by-n quantities; the cost uses the Gram
identity, so the m-by-n reconstruction of chnmf.m:191 is never formed.

Compat note (COMPAT.md): the reference's H update (chnmf.m:187) omits
the G' projection and is shape-inconsistent unless p == k.  The paper's
update (the analog of convexnmf.m:101, without the sqrt) is the default:

    H <- H .* (G'(S_V_pos + S_S_neg G H)) ./ max(G'(S_V_neg + S_S_pos G H) + H_sparsity, eps)

and ``compat="reference"`` runs the literal one where p == k.
"""
from __future__ import annotations

import torch

from ..core import (Result, as_tensor, common_scalars, merge_config,
                    reject_mesh, resolve_device, resolve_dtype, uniform_init)
from ..ops import loop as looplib
from ..ops.gram import pos_neg_split
from ..ops.normalize import unit_sum_columns
from ..utils.init import convex_hull_anchors


def _make_step(StV, StS, v_sq, g_sparsity, h_sparsity, eps, g_fixed, h_fixed,
               compat):
    sv_pos, sv_neg = pos_neg_split(StV)
    ss_pos, ss_neg = pos_neg_split(StS)

    def step(carry, i):
        G, H = carry
        if not g_fixed:
            HHt = H @ H.T
            # ((S_V_pos + S_S_neg G H) H') -> S_V_pos H' + (S_S_neg G)(H H')
            nG = sv_pos @ H.T + (ss_neg @ G) @ HHt
            pG = sv_neg @ H.T + (ss_pos @ G) @ HHt
            G = G * (nG / torch.clamp_min(pG + g_sparsity, eps))  # chnmf.m:180
            G = unit_sum_columns(G)                               # chnmf.m:181
        if not h_fixed:
            if compat:
                # The literal chnmf.m:187 update: no G' projection, so
                # only shape-consistent when p == k (checked at entry).
                nH = sv_pos + (ss_neg @ G) @ H
                pH = sv_neg + (ss_pos @ G) @ H
            else:
                nH = G.T @ sv_pos + (G.T @ ss_neg @ G) @ H
                pH = G.T @ sv_neg + (G.T @ ss_pos @ G) @ H
            H = H * (nH / torch.clamp_min(pH + h_sparsity, eps))
        # 0.5||V - S G H||^2 from the Grams (W = S G, chnmf.m:183,190-192)
        StVG = StV.T @ G           # (n, k): V'(S G)
        GtStSG = G.T @ (StS @ G)   # (k, k)
        c = torch.clamp_min(0.5 * (v_sq - 2.0 * torch.sum(StVG * H.T)
                                   + torch.sum(GtStSG * (H @ H.T))), 0.0)
        return (G, H), c, False

    return step


def chnmf(V, num_basis_elems: int, config: dict | None = None, **kwargs):
    """Convex-hull NMF.  Returns a :class:`Result` as (W, H, S, G, cost)
    with W = S @ G.

    Parameters (chnmf.m:71-167): S_init (hull anchors; default extracted
    from V), pct_eigval_energy (0.95), G_init, H_init, G_sparsity,
    H_sparsity, G_fixed, H_fixed, maxiter (100), tolerance (1e-3).
    Extras: dtype, seed, max_eigvecs (cap on the principal directions
    examined, default 16), compat ("paper" default / "reference": the
    literal chnmf.m:187 H update, which needs hull size p == k), device
    (where a NumPy ``V`` goes; default the CUDA card).  ``mesh`` raises
    ``NotImplementedError``.  The factors come back as tensors on the
    run's device.
    """
    cfg = merge_config(config, kwargs)
    reject_mesh(cfg)
    device = resolve_device(V, cfg.get("device"))
    dtype = resolve_dtype(V, cfg.get("dtype"))
    V = as_tensor(V, dtype, device)
    n = V.shape[1]
    k = int(num_basis_elems)
    maxiter, tolerance, eps, gen = common_scalars(cfg)
    pct = float(cfg.get("pct_eigval_energy", 0.95))
    if not (0.0 <= pct <= 1.0):
        pct = 0.95

    S = cfg.get("S_init")
    if S is None:
        S = convex_hull_anchors(V, pct, int(cfg.get("max_eigvecs", 16)),
                                int(cfg.get("seed", 0)))
    S = as_tensor(S, dtype, device)
    p = S.shape[1]

    G0 = cfg.get("G_init")
    if G0 is None:
        G0 = uniform_init(gen, (p, k), dtype, device, floor_eps=False)  # chnmf.m:111-113
    G0 = unit_sum_columns(as_tensor(G0, dtype, device))                 # chnmf.m:115
    H0 = cfg.get("H_init")
    if H0 is None:
        H0 = uniform_init(gen, (k, n), dtype, device, floor_eps=False)  # chnmf.m:135
    H0 = as_tensor(H0, dtype, device)

    g_sp = max(float(cfg.get("G_sparsity", 0.0) or 0.0), 0.0)
    h_sp = max(float(cfg.get("H_sparsity", 0.0) or 0.0), 0.0)
    compat = str(cfg.get("compat", "paper"))
    if compat not in ("paper", "reference"):
        raise ValueError(f"compat must be 'paper' or 'reference', got {compat!r}")
    if compat == "reference" and p != k:
        raise ValueError(
            f"compat='reference' requires hull size p == k (got p={p}, "
            f"k={k}); the reference's H update (chnmf.m:187) omits the G' "
            "projection and only runs for p == k")

    with torch.no_grad():
        # The one-time Grams (chnmf.m:169-172), formed once here.
        StV = S.T @ V
        StS = S.T @ S
        step = _make_step(StV, StS, torch.sum(V * V), g_sp, h_sp, eps,
                          bool(cfg.get("G_fixed", False)),
                          bool(cfg.get("H_fixed", False)), compat == "reference")
        out = looplib.run(step, (G0, H0), maxiter, tolerance, cost_dtype=dtype)
        G, H = out.state
        W = S @ G
    return Result(fields=("W", "H", "S", "G", "cost"), W=W, H=H, S=S, G=G,
                  cost=looplib.trim_cost(out, maxiter),
                  n_iters=out.n_iters, converged=out.stopped)
