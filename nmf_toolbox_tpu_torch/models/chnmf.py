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

Under a mesh (``parallel.placements_for("chnmf")``) the hull anchors come
from the whole V on every rank (the same bits everywhere), S's rows
shard over features and H's columns over samples, and G is replicated:
S'V and S'S sum over features once at entry, and an iteration sums its
(p, k) and (k, k) products and its cost over samples.
"""
from __future__ import annotations

import torch

from ..core import (Result, as_tensor, common_scalars, merge_config,
                    resolve_device, resolve_dtype, staging_device, uniform_init)
from ..ops import loop as looplib
from ..ops.gram import pos_neg_split
from ..ops.normalize import unit_sum_columns
from ..parallel.collectives import gather_factor, sum_all, sum_features, sum_samples
from ..parallel.mesh import apply_placements, check_mesh
from ..parallel.padding import pad_axes, plan_padding
from ..utils.init import convex_hull_anchors


def _make_step(StV, StS, v_sq, g_sparsity, h_sparsity, eps, g_fixed, h_fixed,
               compat, mesh=None):
    sv_pos, sv_neg = pos_neg_split(StV)
    ss_pos, ss_neg = pos_neg_split(StS)

    def step(carry, i):
        G, H = carry
        if not g_fixed:
            HHt, svh_pos, svh_neg = sum_samples(mesh, H @ H.T, sv_pos @ H.T, sv_neg @ H.T)
            # ((S_V_pos + S_S_neg G H) H') -> S_V_pos H' + (S_S_neg G)(H H')
            nG = svh_pos + (ss_neg @ G) @ HHt
            pG = svh_neg + (ss_pos @ G) @ HHt
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
        lin, HHt = sum_samples(mesh, torch.sum(StVG * H.T), H @ H.T)
        c = torch.clamp_min(0.5 * (v_sq - 2.0 * lin + torch.sum(GtStSG * HHt)), 0.0)
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
    (where a NumPy ``V`` goes; default the CUDA card), mesh
    (``parallel.make_mesh``: every rank calls with the same arguments and
    gets the whole factors).  The factors come back as tensors on the
    run's device.
    """
    cfg = merge_config(config, kwargs)
    mesh = check_mesh(cfg.get("mesh"))
    device = resolve_device(V, cfg.get("device"), mesh)
    dtype = resolve_dtype(V, cfg.get("dtype"))
    src = staging_device(V, device, mesh)  # the whole arrays until placement
    V = as_tensor(V, dtype, src)
    m, n = V.shape
    k = int(num_basis_elems)
    maxiter, tolerance, eps, gen = common_scalars(cfg)
    pct = float(cfg.get("pct_eigval_energy", 0.95))
    if not (0.0 <= pct <= 1.0):
        pct = 0.95

    S = cfg.get("S_init")
    if S is None:
        # The hull search reads the whole V on the run's device, so under
        # a mesh too the whole arrays stay there and placement cuts them.
        src = device
        V = V.to(src)
        S = convex_hull_anchors(V, pct, int(cfg.get("max_eigvecs", 16)),
                                int(cfg.get("seed", 0)))
    S = as_tensor(S, dtype, src)
    p = S.shape[1]

    G0 = cfg.get("G_init")
    if G0 is None:
        G0 = uniform_init(gen, (p, k), dtype, src, floor_eps=False)  # chnmf.m:111-113
    G0 = unit_sum_columns(as_tensor(G0, dtype, src))                 # chnmf.m:115
    H0 = cfg.get("H_init")
    if H0 is None:
        H0 = uniform_init(gen, (k, n), dtype, src, floor_eps=False)  # chnmf.m:135
    H0 = as_tensor(H0, dtype, src)

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

    S_whole = S
    pad_m, pad_n, valid = plan_padding(mesh, m, n)
    if valid is not None:
        V = pad_axes(V, {0: pad_m, 1: pad_n})
        S = pad_axes(S, {0: pad_m})
        H0 = pad_axes(H0, {1: pad_n})
    V, S, G0, H0 = apply_placements(mesh, "chnmf", V=V, S=S, G=G0, H=H0)

    with torch.no_grad():
        # The one-time Grams (chnmf.m:169-172), formed once here.
        StV, StS = sum_features(mesh, S.T @ V, S.T @ S)
        step = _make_step(StV, StS, sum_all(mesh, torch.sum(V * V)), g_sp, h_sp, eps,
                          bool(cfg.get("G_fixed", False)),
                          bool(cfg.get("H_fixed", False)), compat == "reference", mesh)
        del V
        out = looplib.run(step, (G0, H0), maxiter, tolerance, cost_dtype=dtype)
        G, H = out.state
        H = gather_factor(mesh, H, "n", 1)[:, :n]
        S = S_whole.to(device)
        W = S @ G
    return Result(fields=("W", "H", "S", "G", "cost"), W=W, H=H, S=S, G=G,
                  cost=looplib.trim_cost(out, maxiter),
                  n_iters=out.n_iters, converged=out.stopped)
