"""Convex NMF (Ding, Li & Jordan 2010): V ~ (V G) H with G, H >= 0.

PyTorch counterpart of ``nmf_toolbox_tpu/models/convexnmf.py``
(reference: convexnmf.m).  The n-by-n Gram V'V is computed once, before
the loop, and split into positive and negative parts (convexnmf.m:86-87);
the updates are re-associated so that no n-by-n intermediate beyond the
Grams is formed:

    (VV_neg @ G @ H) @ H'  ->  (VV_neg @ G) @ (H @ H')

V'V is symmetric, so the H update and the cost share one Gram-times-
factor product; and a non-negative V (read once per call) makes VV_neg
exactly zero, which leaves 3 large products per iteration instead of 7.

Compat note (COMPAT.md): the reference's default G_init references
undefined variables (convexnmf.m:69-71); the default here is the paper's,
G from the k-means indicator, G = indicator * diag(1/cluster_sizes)
(ValidateParameters.m:105-109).
"""
from __future__ import annotations

import torch

from ..core import (Result, as_tensor, common_scalars, merge_config,
                    reject_mesh, resolve_device, resolve_dtype)
from ..ops import loop as looplib
from ..ops.gram import pos_neg_split
from ..ops.normalize import unit_sum_columns
from ..utils.init import kmeans_indicator_h


def _make_step(grams, v_sq, g_sparsity, g_fixed, h_fixed):
    """The step over the one-time Grams: (V'V,) for a non-negative V,
    (VV_pos, VV_neg) otherwise.  The n^2 k Gram-times-factor products
    dominate; everything else is k-scale."""

    def cost(VtVG, G, H):
        # 0.5||V - V G H||^2 in Gram form (k-by-k only):
        # = 0.5(tr(V'V) - 2 tr(H' G' V'V) + tr((G' V'V G)(H H'))),
        # clamped as ops/gram.euclidean_cost_gram is.
        return torch.clamp_min(0.5 * (v_sq - 2.0 * torch.sum(VtVG * H.T)
                                      + torch.sum((G.T @ VtVG) * (H @ H.T))), 0.0)

    def step_nonneg(carry, i):
        (VtV,) = grams
        G, H = carry
        if not g_fixed:
            HHt = H @ H.T
            pG = VtV @ H.T
            nG = (VtV @ G) @ HHt
            G = G * torch.sqrt(pG / (nG + g_sparsity))  # convexnmf.m:94
            G = unit_sum_columns(G)                      # convexnmf.m:95
        VtVG = VtV @ G  # shared by the H update and the cost
        if not h_fixed:
            GtVV = VtVG.T                                # symmetry of V'V
            H = H * torch.sqrt(GtVV / ((GtVV @ G) @ H))  # convexnmf.m:101
        return (G, H), cost(VtVG, G, H), False

    def step_general(carry, i):
        vv_pos, vv_neg = grams
        G, H = carry
        if not g_fixed:
            HHt = H @ H.T
            # ((VV_pos + VV_neg G H) H') -> VV_pos H' + (VV_neg G)(H H')
            pG = vv_pos @ H.T + (vv_neg @ G) @ HHt
            nG = vv_neg @ H.T + (vv_pos @ G) @ HHt
            G = G * torch.sqrt(pG / (nG + g_sparsity))  # convexnmf.m:94
            G = unit_sum_columns(G)                      # convexnmf.m:95
        PpG = vv_pos @ G  # shared (transposed) by the H update and the cost
        PnG = vv_neg @ G
        if not h_fixed:
            # G'(VV_pos + VV_neg G H) -> (G'VV_pos) + (G'VV_neg G) H
            pH = PpG.T + (PnG.T @ G) @ H
            nH = PnG.T + (PpG.T @ G) @ H
            H = H * torch.sqrt(pH / nH)                  # convexnmf.m:101
        return (G, H), cost(PpG - PnG, G, H), False

    return step_nonneg if len(grams) == 1 else step_general


def convexnmf(V, num_basis_elems: int, config: dict | None = None, **kwargs):
    """Convex NMF; V may be mixed-sign.  Returns a :class:`Result` as
    (W, H, G, cost) with W = V @ G (convexnmf.m:84,97).

    Parameters: G_init (n, k), H_init (k, n), G_sparsity, G_fixed,
    H_fixed, maxiter (100), tolerance (1e-3).  Extras: dtype, seed,
    compat ("paper" default / "reference": the reference's contract that
    G_init must be given), device (where a NumPy ``V`` goes; default the
    CUDA card).  ``mesh`` raises ``NotImplementedError``.  W, H and G
    come back as tensors on the run's device.
    """
    cfg = merge_config(config, kwargs)
    reject_mesh(cfg)
    device = resolve_device(V, cfg.get("device"))
    dtype = resolve_dtype(V, cfg.get("dtype"))
    V = as_tensor(V, dtype, device)
    k = int(num_basis_elems)
    maxiter, tolerance, _, gen = common_scalars(cfg)
    g_sparsity = max(float(cfg.get("G_sparsity", 0.0) or 0.0), 0.0)

    compat = str(cfg.get("compat", "paper"))
    if compat not in ("paper", "reference"):
        raise ValueError(f"compat must be 'paper' or 'reference', got {compat!r}")
    H0 = cfg.get("H_init")
    G0 = cfg.get("G_init")
    if G0 is None and compat == "reference":
        raise ValueError(
            "compat='reference': convexnmf requires an explicit G_init "
            "(the reference's default at convexnmf.m:69-71 references "
            "undefined variables and errors)")
    if H0 is None or G0 is None:
        Hk = kmeans_indicator_h(gen, V, k, dtype)  # indicator + 0.2
        if H0 is None:
            H0 = Hk
        if G0 is None:
            # ValidateParameters.m:105-109: the offset indicator (strictly
            # positive: a zero would stay frozen under the multiplicative
            # update) over the un-offset cluster sizes.
            ind = Hk - 0.2
            G0 = Hk.T / torch.clamp_min(torch.sum(ind, dim=1)[None, :], 1.0)
    G0 = unit_sum_columns(as_tensor(G0, dtype, device))  # convexnmf.m:83
    H0 = as_tensor(H0, dtype, device)

    with torch.no_grad():
        # One read: a non-negative V selects the 3-product step.  The
        # one-time Gram (convexnmf.m:86-87) is formed here, once.
        nonneg = bool(torch.all(V >= 0))
        VtV = V.T @ V
        v_sq = torch.trace(VtV)
        grams = (VtV,) if nonneg else pos_neg_split(VtV)
        step = _make_step(grams, v_sq, g_sparsity, bool(cfg.get("G_fixed", False)),
                          bool(cfg.get("H_fixed", False)))
        out = looplib.run(step, (G0, H0), maxiter, tolerance, cost_dtype=dtype)
        G, H = out.state
        W = V @ G
    return Result(fields=("W", "H", "G", "cost"), W=W, H=H, G=G,
                  cost=looplib.trim_cost(out, maxiter),
                  n_iters=out.n_iters, converged=out.stopped)
