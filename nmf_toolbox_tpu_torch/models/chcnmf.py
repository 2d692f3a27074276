"""Convex-hull convolutive NMF (Vaz 2016): V ~ sum_t S G[:, :, t] H^(t).

PyTorch counterpart of ``nmf_toolbox_tpu/models/chcnmf.py`` (reference:
chcnmf.m, its live code path).  The reference keeps an encoding-space
reconstruction F = sum_t G_t H^(t) (p-by-n) and updates it incrementally
with a clamp after each frame's multiplicative step (chcnmf.m:315,
363-368), so the frame loop is sequential.  The rest runs in (p, n) and
(k, n) space after the one-time Grams S'V and S'S:

* the frames' data terms S'V_pos Hs[t]' and S'V_neg Hs[t]' do not depend
  on F, so each is one (p, n) @ (n, T*k) GEMM before the frame loop; a
  frame then needs F Hs[t]' (p, k) and its clamped F update;
* the H gradient over the shifted identities (chcnmf.m:374-383) is
  ``conv_wt_phi(G, S'V_pos + S'S_neg F)``: one GEMM over T and T shifts;
* the cost 0.5||V - S F||^2 = 0.5(||V||^2 - 2<S'V, F> + <S'S F, F>) is
  read from F, which the next iteration starts from.

Given W_init, G_init is fitted by the reference's inner MU loop
(W_t ~ S G_t, at most 100 iterations, tol 1e-5; chcnmf.m:140-170);
W_fixed implies G_fixed (chcnmf.m:133-137).

Under a mesh (``parallel.placements_for("chcnmf")``) the placed data is
the (p, n) Gram S'V, its columns sharded over samples: S'V, S'S and
||V||^2 sum over features and samples once at entry, from V and S's rows
placed like nmf's V and W.  G is replicated; an iteration sums each
frame's (p, k) products and the cost over samples, H's shifts take the
T - 1 columns of context of the neighbouring blocks
(``parallel.collectives.halo``).  The fit of G to a W_init runs on S's
and W_init's rows, its residuals summed over features, so every rank
reads the same stop flag.
"""
from __future__ import annotations

import torch

from ..core import (Result, as_tensor, common_scalars, merge_config,
                    resolve_device, resolve_dtype, staging_device, uniform_init)
from ..ops import loop as looplib
from ..ops.gram import pos_neg_split
from ..ops.normalize import unit_sum_columns
from ..ops.shift import conv_reconstruct, conv_wt_phi, stack_shifts_right
from ..parallel.collectives import gather_factor, sum_all, sum_features, sum_samples
from ..parallel.mesh import apply_placements, check_mesh, shard
from ..parallel.padding import pad_axes, plan_padding
from ..utils.init import convex_hull_anchors


def _make_step(StV, StS, v_sq, g_sparsity, h_sparsity, eps, T, g_fixed, h_fixed,
               n_valid=None, mesh=None):
    sv_pos, sv_neg = pos_neg_split(StV)
    ss_pos, ss_neg = pos_neg_split(StS)

    def stack(H):
        return stack_shifts_right(H, T, n_valid, mesh)

    def cost(F, H):
        lin, sq, h1 = sum_samples(mesh, torch.sum(StV * F), torch.sum((StS @ F) * F),
                                  torch.sum(H))
        return torch.clamp_min(0.5 * (v_sq - 2.0 * lin + sq), 0.0) + h_sparsity * h1

    def step(carry, i):
        G0, H, F = carry  # F = sum_t G0_t H^(t)
        G = G0
        Hs = stack(H)
        if not g_fixed:
            svh_pos, svh_neg = sum_samples(
                mesh, (sv_pos @ Hs.flatten(0, 1).T).unflatten(1, (T, -1)),  # (p, T, k)
                (sv_neg @ Hs.flatten(0, 1).T).unflatten(1, (T, -1)))
            frames = []
            for t in range(T):  # sequential: F is clamped after each frame
                FH = sum_samples(mesh, F @ Hs[t].T)
                num = svh_pos[:, t] + ss_neg @ FH  # (S'V_pos + S'S_neg F) Hs[t]'
                den = svh_neg[:, t] + ss_pos @ FH
                Gt = unit_sum_columns(G0[:, :, t] * (num / torch.clamp_min(
                    den + g_sparsity, eps)))
                F = torch.clamp_min(F + (Gt - G0[:, :, t]) @ Hs[t], 0.0)  # chcnmf.m:367
                frames.append(Gt)
            G = torch.stack(frames, dim=2)
        if not h_fixed:
            F = conv_reconstruct(G, H, Hs=Hs)  # chcnmf.m:375
            neg = conv_wt_phi(G, sv_pos + ss_neg @ F, mesh)
            pos = conv_wt_phi(G, sv_neg + ss_pos @ F, mesh)
            H = H * (neg / torch.clamp_min(pos + h_sparsity, eps))
            Hs = stack(H)
        # G0 is committed after the convergence check in the reference
        # (chcnmf.m:431-437); it only feeds the next iteration, so
        # committing here is equivalent.
        F = conv_reconstruct(G, H, Hs=Hs)
        return (G, H, F), cost(F, H), False

    return step, cost


def _fit_g_to_w(S, W_init, G0, tol=1e-5, iters=100, mesh=None):
    """Inner MU fit of G_t with W_t ~ S G_t (chcnmf.m:140-170), all T
    frames stepped together.  Each frame runs the reference's own loop:
    it stops once its residual falls by no more than ``tol``, after at
    most ``iters`` steps, and keeps that G while the other frames go on.
    The host reads one flag per step, whether any frame is still running.
    ``mesh``: S and W_init hold this rank's rows; the Grams and the
    residuals sum over features, so the flag is the same on every rank."""
    p, k, T = G0.shape
    StS, StW = sum_features(mesh, S.T @ S, S.T @ W_init.flatten(1))
    ss_pos, ss_neg = pos_neg_split(StS)
    sw_pos, sw_neg = pos_neg_split(StW.view(p, k, T))

    def ss(A, G):
        return (A @ G.flatten(1)).view(p, k, T)

    G = unit_sum_columns(G0)
    prev = torch.full((T,), float("inf"), dtype=G.dtype, device=G.device)
    done = torch.zeros((T,), dtype=torch.bool, device=G.device)
    for _ in range(iters):
        Gn = unit_sum_columns(G * ((sw_pos + ss(ss_neg, G)) / (sw_neg + ss(ss_pos, G))))
        r = W_init - (S @ Gn.flatten(1)).view(W_init.shape)
        cur = sum_features(mesh, 0.5 * torch.sum(r * r, dim=(0, 1)))
        run = ~done
        G = torch.where(run, Gn, G)
        done = done | (run & (cur <= prev) & (prev - cur <= tol))
        prev = torch.where(run, cur, prev)
        if bool(torch.all(done)):
            break
    return G


def chcnmf(V, num_basis_elems: int, context_len: int,
           config: dict | None = None, **kwargs):
    """Convex-hull convolutive NMF.  Returns a :class:`Result` as
    (W, H, S, G, cost) with W[:, :, t] = S @ G[:, :, t].

    Parameters (chcnmf.m:9-82): S_init (default: the hull anchors of V),
    pct_eigval_energy (0.95), W_init (fits G_init by the inner MU loop),
    G_init (p, k, T), H_init (k, n), G_sparsity, H_sparsity, W_fixed
    (implies G_fixed), G_fixed, H_fixed, maxiter (100), tolerance (1e-3).
    Extras: dtype, seed, eps, max_eigvecs (cap on the principal
    directions the hull search examines, default 16), device (where a
    NumPy ``V`` goes; default the CUDA card), mesh
    (``parallel.make_mesh``: every rank calls with the same arguments and
    gets the whole factors).  cost[0] is the initial cost.  The factors
    come back as tensors on the run's device.
    """
    cfg = merge_config(config, kwargs)
    mesh = check_mesh(cfg.get("mesh"))
    device = resolve_device(V, cfg.get("device"), mesh)
    dtype = resolve_dtype(V, cfg.get("dtype"))
    src = staging_device(V, device, mesh)  # the whole arrays until placement
    V = as_tensor(V, dtype, src)
    m, n = V.shape
    k, T = int(num_basis_elems), int(context_len)
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
    g_fixed = bool(cfg.get("G_fixed", False)) or bool(cfg.get("W_fixed", False))
    pad_m, pad_n, valid = plan_padding(mesh, m, n)
    S_rows = apply_placements(mesh, "chcnmf", S=pad_axes(S, {0: pad_m}))

    W_init, G0 = cfg.get("W_init"), cfg.get("G_init")
    with torch.no_grad():
        if W_init is not None:
            G_rand = uniform_init(gen, (p, k, T), dtype, device, floor_eps=False)
            W_init = pad_axes(as_tensor(W_init, dtype, src), {0: pad_m})
            W_rows = W_init if mesh is None else shard(mesh, W_init, ("m", None, None))
            G0 = _fit_g_to_w(S_rows, W_rows, G_rand, mesh=mesh)
        elif G0 is None:
            G0 = uniform_init(gen, (p, k, T), dtype, device, floor_eps=False)
        G0 = unit_sum_columns(as_tensor(G0, dtype, device))  # per-frame column sums 1
        H0 = cfg.get("H_init")
        if H0 is None:
            H0 = uniform_init(gen, (k, n), dtype, src, floor_eps=False)
        H0 = as_tensor(H0, dtype, src)
        g_sp = max(float(cfg.get("G_sparsity", 0.0) or 0.0), 0.0)
        h_sp = max(float(cfg.get("H_sparsity", 0.0) or 0.0), 0.0)

        # The one-time Grams: the loop never touches the m-by-n data.
        if valid is not None:
            V = pad_axes(V, {0: pad_m, 1: pad_n})
            H0 = pad_axes(H0, {1: pad_n})
        V, H0 = apply_placements(mesh, "nmf", V=V, H=H0)
        StV, StS = sum_features(mesh, S_rows.T @ V, S_rows.T @ S_rows)
        v_sq = sum_all(mesh, torch.sum(V * V))
        del V
        step, cost = _make_step(StV, StS, v_sq, g_sp, h_sp, eps, T, g_fixed,
                                bool(cfg.get("H_fixed", False)),
                                None if valid is None else n, mesh)
        F0 = conv_reconstruct(G0, H0, None if valid is None else n, mesh)
        c0 = cost(F0, H0)
        out = looplib.run(step, (G0, H0, F0), maxiter, tolerance, offset=1,
                          initial_cost=c0, cost_dtype=dtype)
        G, H, _ = out.state
        H = gather_factor(mesh, H, "n", 1)[:, :n]
        S = S.to(device)
        W = (S @ G.flatten(1)).view(m, k, T)
    return Result(fields=("W", "H", "S", "G", "cost"), W=W, H=H, S=S, G=G,
                  cost=looplib.trim_cost(out, maxiter, offset=1),
                  n_iters=out.n_iters, converged=out.stopped)
