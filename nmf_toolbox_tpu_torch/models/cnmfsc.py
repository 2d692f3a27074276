"""Convolutive NMF with Hoyer sparseness constraints (Ramanarayanan 2013).

PyTorch counterpart of ``nmf_toolbox_tpu/models/cnmfsc.py`` (reference:
cnmfsc.m), the toolbox's most stateful solver.  Kept from the reference:

* a double-buffered basis: updates read W0 and write W, committed at the
  end of each iteration unless it terminated (cnmfsc.m:94-96,266) —
  including the quirk that the initial sparsity projection writes W but
  not W0 (cnmfsc.m:106-110), and that the H-phase row renorm scales W0
  only (cnmfsc.m:204-209);
* per-frame stepsizes for the W line searches (cnmfsc.m:147), each
  frame's begobj the previous frame's accepted objective, and the W
  objective a 2-D reconstruction Wnew @ H (cnmfsc.m:218,235);
* the non-sparse W branch's clamped incremental V_hat
  V_hat = max(V_hat + (W_t - W0_t) H_shifted, 0) (cnmfsc.m:262);
* the non-sparse H MU guard (pos + eps), not max(pos, eps) (cnmfsc.m:202).

Line-search objectives are evaluated in Gram form: with the basis
frozen, 0.5||V - sum_t W_t H^(t)||^2 needs the (T, T, k, k) cross-Grams
of W and of H's shift stack, never an m-by-n reconstruction.  The H
phase's positive gradient sum_t W0_t' (sum_s W_s H^(s))<-t is one
(T*k, T*k) cross-Gram W0'W over m and one (T*k, T*k) @ (T*k, n) GEMM
before the T shifts (ops/shift.py's layout); the non-sparse W branch's
V H^(t)' for all t is one GEMM.

Under a mesh (``parallel.placements_for("cnmfsc")``) the blocks, sums
and projections are nmfsc's, and every shift takes its T - 1 columns of
context from the neighbouring blocks (``parallel.collectives.halo``),
a line search's candidates included; the non-sparse W branch sums each
frame's V_hat Hs[t]' over samples.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import (Result, as_tensor, common_scalars, full_f32_matmul,
                    ingest_rescaled, merge_config, resolve_device,
                    resolve_dtype, staging_device, uniform_init)
from ..ops import loop as looplib
from ..ops.gram import conv_cross_grams_h, conv_cross_grams_w
from ..ops.linesearch import host_scalar_type, make_search, resolve_width
from ..ops.projection import hoyer_l1_target, project_rows
from ..ops.shift import (conv_reconstruct, conv_wt_phi, flatten_frames, phi_ht,
                         shift_sum, stack_shifts_right)
from ..parallel.collectives import gather_factor, sum_all, sum_features, sum_samples
from ..parallel.mesh import apply_placements, check_mesh
from ..parallel.padding import pad_axes, plan_padding
from .nmfsc import MATRIX, gram_cost_w


def _make_step(V, spec, search, valid=None, mesh=None):
    """One cnmfsc iteration on the state (W0, W, H, step_w, step_h,
    cost); ``step_w`` is a (T,) host array in V's dtype.  ``valid``: the
    true (m, n) of a mesh-padded V."""
    T, w_sparse, h_sparse, w_fixed, h_fixed, eps, l1_w, l1_h = spec
    mv, nv = (None, None) if valid is None else valid
    v_sq = sum_all(mesh, torch.sum(V * V))

    def stack(H):
        return stack_shifts_right(H, T, nv, mesh)

    def proj_rows(H):
        return project_rows(H, l1_h, 1.0, nv, mesh, "n")[0]

    def proj_cols(W2d):
        return project_rows(W2d.mT, l1_w, 1.0, mv, mesh, "m")[0].mT

    def step(state, i):
        W0, W, H, step_w, step_h, prev_cost = state
        term = False

        # ---- H phase (cnmfsc.m:156-211): gradients read W0, but the
        # V_hat entering this phase was reconstructed from the committed
        # W (cnmfsc.m:152/269; W differs from W0 only in iteration 1) ----
        if not h_fixed:
            # sum_t W0_t' V<-t (cnmfsc.m:161-163), and [(t,k),(s,l)] = W0_t' W_s
            grams = (conv_wt_phi(W0, V, mesh), flatten_frames(W0).T @ flatten_frames(W))
            if h_sparse:
                neg, WX, WW0 = sum_features(mesh, *grams, conv_cross_grams_w(W0))
            else:
                neg, WX = sum_features(mesh, *grams)
            Hs = stack(H).flatten(-3, -2)  # (T*k, n)
            pos = shift_sum((WX @ Hs).unflatten(-2, (T, -1)), mesh)
            if h_sparse:
                def obj_h(Hn):
                    lin = torch.sum(neg * Hn, dim=MATRIX)
                    HH = conv_cross_grams_h(stack(Hn))
                    if mesh is not None:
                        lin, HH = sum_samples(mesh, lin, HH)
                    sq = torch.sum(WW0 * HH, dim=(-4, -3, -2, -1))
                    return 0.5 * (v_sq - 2.0 * lin + sq)
                H, step_h, term, _ = search(obj_h, H, pos - neg, step_h,
                                            proj_rows, prev_cost)
            else:
                H = H * (neg / (pos + eps))  # (pos + eps)! cnmfsc.m:202
                norms = torch.sqrt(sum_samples(mesh, torch.sum(H * H, dim=1)))
                H = H / norms[:, None]
                W0 = W0 * norms[None, :, None]  # scales W0 only (cnmfsc.m:207-209)

        # ---- W phase (cnmfsc.m:213-265), skipped once terminated (the
        # reference returned before it) ----
        if not w_fixed and not term:
            W = W.clone()  # the frames are written one by one below
            Hs = stack(H)
            if w_sparse:
                step_w = step_w.copy()
                HH, VHt_all = sum_samples(mesh, conv_cross_grams_h(Hs),  # HH[s, t] = Hs[s] Hs[t]'
                                          phi_ht(V, Hs))                 # (m, k, T)
                lin, WW0 = sum_features(mesh, torch.sum(VHt_all * W0),
                                        conv_cross_grams_w(W0))
                begobj = 0.5 * (v_sq - 2.0 * lin + torch.sum(WW0 * HH))
                G00, VHt0 = HH[0, 0], VHt_all[:, :, 0]
                obj_2d = lambda Wn: gram_cost_w(v_sq, VHt0, G00, Wn, mesh)  # noqa: E731

                Wprev = None
                for t in range(T):
                    if t == 0:
                        pos = torch.einsum("mks,skl->ml", W0, HH[:, 0])
                    else:
                        pos = Wprev @ HH[0, t]
                    Wnew, st_new, term, begobj = search(  # next frame's begobj (cnmfsc.m:218)
                        obj_2d, W0[:, :, t], pos - VHt_all[:, :, t], step_w[t],
                        proj_cols, begobj)
                    if term:
                        break
                    W[:, :, t] = Wnew
                    step_w[t] = st_new
                    Wprev = Wnew
            else:
                V_hat = conv_reconstruct(W0, H, Hs=Hs)  # cnmfsc.m:215
                negs = sum_samples(mesh, phi_ht(V, Hs))  # V @ Hs[t]' for all t
                for t in range(T):
                    den = sum_samples(mesh, V_hat @ Hs[t].T)
                    Wt = W0[:, :, t] * (negs[:, :, t] / torch.clamp_min(den, eps))
                    W[:, :, t] = Wt
                    V_hat = torch.clamp_min(V_hat + (Wt - W0[:, :, t]) @ Hs[t], 0.0)  # cnmfsc.m:262

        if term:  # no commit; the loop stops and trims this cost
            return (W0, W, H, step_w, step_h, prev_cost), prev_cost, True
        W0 = W  # commit the double buffer (cnmfsc.m:266)
        c = conv_cost(V, W0, H, nv, mesh)
        return (W0, W, H, step_w, step_h, c), c, False

    return step


def conv_cost(V, W, H, n_valid=None, mesh=None):
    """0.5||V - conv_reconstruct(W, H)||^2 in residual form (cnmfsc.m:269);
    ``mesh``: summed over every rank's block."""
    r = V - conv_reconstruct(W, H, n_valid, mesh)
    return sum_all(mesh, 0.5 * torch.sum(r * r))


def cnmfsc(V, num_basis_elems: int, context_len: int,
           config: dict | None = None, **kwargs):
    """Convolutive NMF with sparseness constraints.  Returns (W, H, cost).

    Parameters (cnmfsc.m:9-45): W_init (m, k, T), H_init,
    W_sparsity/H_sparsity in [0, 1], W_fixed, H_fixed, maxiter (100),
    tolerance (1e-3), seed, dtype, eps, device, linesearch_width (as in
    ``nmfsc``), resume_state ({"step_w": a (T,) array, "step_h"} of an
    earlier run, whose W and H come as the inits).  V must be
    non-negative; it is rescaled by its max (cnmfsc.m:68-73).  cost[0] is
    the initial cost.  Matmuls run in full f32 whatever the caller's TF32
    settings.  ``mesh`` (``parallel.make_mesh``): every rank calls with
    the same arguments and gets the whole W and H.  W and H are tensors
    on the run's device; resume_state holds a NumPy (T,) step_w and a
    float step_h.
    """
    cfg = merge_config(config, kwargs)
    mesh = check_mesh(cfg.get("mesh"))
    device = resolve_device(V, cfg.get("device"), mesh)
    dtype = resolve_dtype(V, cfg.get("dtype"))
    src = staging_device(V, device, mesh)  # the whole arrays until placement
    V = ingest_rescaled(V, dtype, src)  # cnmfsc.m:68-73
    m, n = V.shape
    k, T = int(num_basis_elems), int(context_len)

    maxiter, tolerance, eps, gen = common_scalars(cfg)
    w_sp = min(float(cfg.get("W_sparsity", 0.0) or 0.0), 1.0)
    h_sp = min(float(cfg.get("H_sparsity", 0.0) or 0.0), 1.0)

    W0 = cfg.get("W_init")
    W0 = (uniform_init(gen, (m, k, T), dtype, src, floor_eps=False) if W0 is None
          else as_tensor(W0, dtype, src))  # cnmfsc.m:84-86
    H0 = cfg.get("H_init")
    if H0 is None:
        H0 = uniform_init(gen, (k, n), dtype, src, floor_eps=False)
        H0 = H0 / torch.sqrt(torch.sum(H0 * H0, dim=1, keepdim=True))  # cnmfsc.m:89-92
    else:
        H0 = as_tensor(H0, dtype, src)

    l1_w = hoyer_l1_target(m, w_sp) if w_sp > 0 else 0.0
    l1_h = hoyer_l1_target(n, h_sp) if h_sp > 0 else 0.0
    # Continuation: skip the initial projections and resume the per-frame
    # stepsizes and the H stepsize (cnmfsc.m:147).  At a committed
    # iteration W0 == W (cnmfsc.m:266), so W_init fills both buffers.
    rs = cfg.get("resume_state") or None
    t = host_scalar_type(dtype)
    step_w = (np.array(rs["step_w"], dtype=t) if rs is not None
              else np.ones((T,), dtype=t))
    if step_w.shape != (T,):
        raise ValueError(f"resume_state step_w has shape {step_w.shape}, "
                         f"expected ({T},)")
    step_h = t(rs["step_h"] if rs is not None else 1.0)
    spec = (T, w_sp > 0, h_sp > 0, bool(cfg.get("W_fixed", False)),
            bool(cfg.get("H_fixed", False)), eps, l1_w, l1_h)
    search = make_search(resolve_width(cfg.get("linesearch_width")))
    with full_f32_matmul():
        # The initial projections write W, NOT the W0 buffer (cnmfsc.m:94-124).
        W_proj = W0
        if rs is None:
            if w_sp > 0:
                W_proj = project_rows(W0.reshape(m, k * T).T, l1_w, 1.0)[0].T.reshape(m, k, T)
            if h_sp > 0:
                H0 = project_rows(H0, l1_h, 1.0)[0]
        pad_m, pad_n, valid = plan_padding(mesh, m, n)
        if valid is not None:
            V = pad_axes(V, {0: pad_m, 1: pad_n})
            W0 = pad_axes(W0, {0: pad_m})
            W_proj = pad_axes(W_proj, {0: pad_m})
            H0 = pad_axes(H0, {1: pad_n})
        V, W0, W_proj, H0 = apply_placements(mesh, "cnmfsc", V=V, W=W0, W2=W_proj, H=H0)
        nv = None if valid is None else n
        c0 = conv_cost(V, W_proj, H0, nv, mesh)  # the initial cost uses W (cnmfsc.m:152)
        out = looplib.run(_make_step(V, spec, search, valid, mesh),
                          (W0, W_proj, H0, step_w, step_h, c0), maxiter, tolerance,
                          offset=1, initial_cost=c0, cost_dtype=dtype)
    _, W, H, step_w, step_h, _ = out.state
    W = gather_factor(mesh, W, "m", 0)[:m]
    H = gather_factor(mesh, H, "n", 1)[:, :n]
    return Result(fields=("W", "H", "cost"), W=W, H=H,
                  cost=looplib.trim_cost(out, maxiter, offset=1),
                  n_iters=int(out.n_iters),
                  converged=bool(out.stopped) or bool(out.terminated),
                  resume_state={"step_w": np.asarray(step_w), "step_h": float(step_h)})
