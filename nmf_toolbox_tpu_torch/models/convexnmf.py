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

Under a mesh (``parallel.placements_for("convexnmf")``) G's rows and
H's columns shard over samples, and no rank holds the whole n-by-n Gram:
each builds its own rows of V'V at entry, V[:, rows]' V, from the whole
V that every rank is called with (in column chunks when V is not on the
run's device).  An iteration gathers G (and, for the G update, H) over
samples, k n values each, multiplies its Gram rows locally and sums the
k-by-k products over samples.  W = V G sums over samples and is gathered
over features at the end.

Compat note (COMPAT.md): the reference's default G_init references
undefined variables (convexnmf.m:69-71); the default here is the paper's,
G from the k-means indicator, G = indicator * diag(1/cluster_sizes)
(ValidateParameters.m:105-109).
"""
from __future__ import annotations

import torch

from ..core import (Result, as_tensor, common_scalars, concrete_device, merge_config,
                    resolve_device, resolve_dtype, staging_device)
from ..ops import loop as looplib
from ..ops.gram import pos_neg_split
from ..ops.masking import col_mask
from ..ops.normalize import unit_sum_columns
from ..parallel.collectives import gather_factor, sum_samples
from ..parallel.mesh import apply_placements, block_offset, check_mesh
from ..parallel.padding import pad_axes, plan_padding
from ..utils.init import kmeans_indicator_h

GRAM_CHUNK_BYTES = 1 << 28  # V's column chunks for a row Gram built off its device


def row_gram(V, r0: int, r1: int, device):
    """Rows r0 .. r1 of V'V, (r1 - r0, n) on ``device``, from the whole V:
    V[:, r0:r1]' V, with V's columns moved in chunks when V lies
    elsewhere."""
    device = concrete_device(device)
    if V.device == device:
        return V[:, r0:r1].T @ V
    m, n = V.shape
    Vr = V[:, r0:r1].to(device)
    step = max(1, GRAM_CHUNK_BYTES // (m * V.element_size()))
    out = torch.empty((r1 - r0, n), dtype=V.dtype, device=device)
    for c in range(0, n, step):
        out[:, c:c + step] = Vr.T @ V[:, c:c + step].to(device)
    return out


def _make_step(grams, v_sq, g_sparsity, g_fixed, h_fixed, n_valid=None, mesh=None):
    """The step over the one-time Grams: (V'V,) for a non-negative V,
    (VV_pos, VV_neg) otherwise, this rank's rows of them under a mesh.
    The n^2 k Gram-times-factor products dominate; everything else is
    k-scale."""
    b = grams[0].shape[0]
    cmask = col_mask(b, n_valid, grams[0].device, block_offset(mesh, b))

    def masked(ratio, colwise: bool):
        """The 0/0 sqrt ratios of a padded problem's pad rows of G and
        pad columns of H, pinned to zero."""
        if cmask is None:
            return ratio
        sel = cmask[None, :] if colwise else cmask[:, None]
        return torch.where(sel, ratio, torch.zeros((), dtype=ratio.dtype,
                                                   device=ratio.device))

    def whole(X, dim):  # G (rows) or H (columns) of every rank
        return gather_factor(mesh, X, "n", dim)

    def cost(VtVG, G, H):
        # 0.5||V - V G H||^2 in Gram form (k-by-k only):
        # = 0.5(tr(V'V) - 2 tr(H' G' V'V) + tr((G' V'V G)(H H'))),
        # clamped as ops/gram.euclidean_cost_gram is.
        lin, GtVVG, HHt = sum_samples(mesh, torch.sum(VtVG * H.T), G.T @ VtVG, H @ H.T)
        return torch.clamp_min(0.5 * (v_sq - 2.0 * lin + torch.sum(GtVVG * HHt)), 0.0)

    def step_nonneg(carry, i):
        (VtV,) = grams
        G, H = carry
        if not g_fixed:
            HHt = sum_samples(mesh, H @ H.T)
            pG = VtV @ whole(H, 1).T
            nG = (VtV @ whole(G, 0)) @ HHt
            G = G * torch.sqrt(masked(pG / (nG + g_sparsity), False))  # convexnmf.m:94
            G = unit_sum_columns(G, mesh, "n")                          # convexnmf.m:95
        VtVG = VtV @ whole(G, 0)  # shared by the H update and the cost
        if not h_fixed:
            GtVV = VtVG.T                                # symmetry of V'V
            GtVVG = sum_samples(mesh, GtVV @ G)
            H = H * torch.sqrt(masked(GtVV / (GtVVG @ H), True))  # convexnmf.m:101
        return (G, H), cost(VtVG, G, H), False

    def step_general(carry, i):
        vv_pos, vv_neg = grams
        G, H = carry
        if not g_fixed:
            HHt = sum_samples(mesh, H @ H.T)
            Hw, Gw = whole(H, 1), whole(G, 0)
            # ((VV_pos + VV_neg G H) H') -> VV_pos H' + (VV_neg G)(H H')
            pG = vv_pos @ Hw.T + (vv_neg @ Gw) @ HHt
            nG = vv_neg @ Hw.T + (vv_pos @ Gw) @ HHt
            G = G * torch.sqrt(masked(pG / (nG + g_sparsity), False))  # convexnmf.m:94
            G = unit_sum_columns(G, mesh, "n")                          # convexnmf.m:95
        Gw = whole(G, 0)
        PpG = vv_pos @ Gw  # shared (transposed) by the H update and the cost
        PnG = vv_neg @ Gw
        if not h_fixed:
            # G'(VV_pos + VV_neg G H) -> (G'VV_pos) + (G'VV_neg G) H
            GnG, GpG = sum_samples(mesh, PnG.T @ G, PpG.T @ G)
            pH = PpG.T + GnG @ H
            nH = PnG.T + GpG @ H
            H = H * torch.sqrt(masked(pH / nH, True))   # convexnmf.m:101
        return (G, H), cost(PpG - PnG, G, H), False

    return step_nonneg if len(grams) == 1 else step_general


def convexnmf(V, num_basis_elems: int, config: dict | None = None, **kwargs):
    """Convex NMF; V may be mixed-sign.  Returns a :class:`Result` as
    (W, H, G, cost) with W = V @ G (convexnmf.m:84,97).

    Parameters: G_init (n, k), H_init (k, n), G_sparsity, G_fixed,
    H_fixed, maxiter (100), tolerance (1e-3).  Extras: dtype, seed,
    compat ("paper" default / "reference": the reference's contract that
    G_init must be given), device (where a NumPy ``V`` goes; default the
    CUDA card), mesh (``parallel.make_mesh``: every rank calls with the
    same arguments and gets the whole factors).  W, H and G come back as
    tensors on the run's device.
    """
    cfg = merge_config(config, kwargs)
    mesh = check_mesh(cfg.get("mesh"))
    device = resolve_device(V, cfg.get("device"), mesh)
    dtype = resolve_dtype(V, cfg.get("dtype"))
    src = staging_device(V, device, mesh)  # the whole arrays until placement
    V = as_tensor(V, dtype, src)
    m, n = V.shape
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
        # The k-means reads the whole V on the run's device, so under a
        # mesh too the whole arrays stay there and placement cuts them.
        src = device
        V = V.to(src)
        Hk = kmeans_indicator_h(gen, V, k, dtype)  # indicator + 0.2
        if H0 is None:
            H0 = Hk
        if G0 is None:
            # ValidateParameters.m:105-109: the offset indicator (strictly
            # positive: a zero would stay frozen under the multiplicative
            # update) over the un-offset cluster sizes.
            ind = Hk - 0.2
            G0 = Hk.T / torch.clamp_min(torch.sum(ind, dim=1)[None, :], 1.0)
    # convexnmf.m:83; row-major, as placement makes it (the k-means G0 is a transpose)
    G0 = unit_sum_columns(as_tensor(G0, dtype, src)).contiguous()
    H0 = as_tensor(H0, dtype, src)

    pad_m, pad_n, valid = plan_padding(mesh, m, n)
    if valid is not None:
        V = pad_axes(V, {0: pad_m, 1: pad_n})
        G0 = pad_axes(G0, {0: pad_n})  # G is (n, k): rows follow samples
        H0 = pad_axes(H0, {1: pad_n})
    Vb, G0, H0 = apply_placements(mesh, "convexnmf", V=V, G=G0, H=H0)

    with torch.no_grad():
        # One read: a non-negative V selects the 3-product step.  The
        # one-time Gram (convexnmf.m:86-87), this rank's rows of it, is
        # formed here, once.
        nonneg = bool(torch.all(V >= 0))
        r0 = block_offset(mesh, G0.shape[0])
        VtV = row_gram(V, r0, r0 + G0.shape[0], device)
        del V
        v_sq = sum_samples(mesh, torch.trace(VtV[:, r0:r0 + G0.shape[0]]))
        grams = (VtV,) if nonneg else pos_neg_split(VtV)
        del VtV
        step = _make_step(grams, v_sq, g_sparsity, bool(cfg.get("G_fixed", False)),
                          bool(cfg.get("H_fixed", False)),
                          None if valid is None else n, mesh)
        out = looplib.run(step, (G0, H0), maxiter, tolerance, cost_dtype=dtype)
        G, H = out.state
        W = gather_factor(mesh, sum_samples(mesh, Vb @ G), "m", 0)[:m]
        G = gather_factor(mesh, G, "n", 0)[:n]
        H = gather_factor(mesh, H, "n", 1)[:, :n]
    return Result(fields=("W", "H", "G", "cost"), W=W, H=H, G=G,
                  cost=looplib.trim_cost(out, maxiter),
                  n_iters=out.n_iters, converged=out.stopped)
