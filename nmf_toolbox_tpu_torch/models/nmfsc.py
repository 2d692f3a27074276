"""NMF with sparseness constraints (Hoyer 2004).

PyTorch counterpart of ``nmf_toolbox_tpu/models/nmfsc.py`` (reference:
nmfsc.m).  Euclidean only, single source; sparsity in [0, 1] maps to an
L1 target for unit-L2 vectors (nmfsc.m:93,106); sparse factors move by
projected gradient descent with a backtracking line search
(ops/linesearch.py: halve until the objective does not increase, grow
1.2x on success, stop when the stepsize underflows — nmfsc.m:148-233);
non-sparse factors fall back to plain MU with an H-row renormalization
that transfers norms into W (nmfsc.m:182-187).

The line-search objective 0.5*||V - W Hnew||^2 is evaluated in Gram
form with the other factor frozen, so a trial costs O(n k^2) (H) or
O(m k^2) (W), never an m-by-n reconstruction; each trial projects every
row (H) or column (W) at once (ops/projection.py).  The sums and
products keep the JAX package's association, so accept/halve decisions
agree with it in f64.  The outer loop is ops/loop.run on the host; the
line searches read one flag per trial, so an iteration's host reads are
its trials, its projection groups and the stop rule.
"""
from __future__ import annotations

import torch

from ..core import (Result, as_tensor, common_scalars, full_f32_matmul,
                    ingest_rescaled, merge_config, reject_mesh, resolve_device,
                    resolve_dtype, uniform_init)
from ..ops import loop as looplib
from ..ops.linesearch import host_scalar_type, make_search, resolve_width
from ..ops.normalize import row_l2_transfer
from ..ops.projection import hoyer_l1_target, project_rows

MATRIX = (-2, -1)  # a candidate's factor: the objective sums over these


def gram_cost(v_sq, WtV, WtW, H):
    """0.5||V - W H||^2 = 0.5(||V||^2 - 2<W'V, H> + <W'W H, H>) per
    candidate H (..., k, n), in the JAX package's association."""
    return 0.5 * (v_sq - 2.0 * torch.sum(WtV * H, dim=MATRIX)
                  + torch.sum((WtW @ H) * H, dim=MATRIX))


def gram_cost_w(v_sq, VHt, HHt, W):
    """The same objective for candidates W (..., m, k) with H frozen."""
    return 0.5 * (v_sq - 2.0 * torch.sum(VHt * W, dim=MATRIX)
                  + torch.sum((W.mT @ W) * HHt, dim=MATRIX))


def _make_step(V, spec, search):
    """``(step, cost)``: one iteration on the state (W, H, step_w,
    step_h, cost, W'V, W'W), and the clamped cost of (W, H) with the
    Grams it formed.  The Grams of the committed W ride the state into
    the next H update, which JAX forms anew: the same products, one
    m-by-n GEMM fewer per iteration."""
    w_sparse, h_sparse, w_fixed, h_fixed, eps, l1_w, l1_h = spec
    v_sq = torch.sum(V * V)

    def proj_rows(H):
        return project_rows(H, l1_h, 1.0)[0]

    def proj_cols(W):
        return project_rows(W.mT, l1_w, 1.0)[0].mT

    def cost(W, H):
        # clamp: see ops/gram.euclidean_cost_gram (nmfsc.m:237-238)
        WtV, WtW = W.T @ V, W.T @ W
        return torch.clamp_min(gram_cost(v_sq, WtV, WtW, H), 0.0), WtV, WtW

    def step(state, i):
        W, H, step_w, step_h, prev_cost, WtV, WtW = state
        term = False
        # ---- H update (nmfsc.m:143-189) ----
        if not h_fixed:
            if h_sparse:
                dH = WtW @ H - WtV  # positive_grad - negative_grad
                H, step_h, term, _ = search(
                    lambda Hn: gram_cost(v_sq, WtV, WtW, Hn), H, dH, step_h,
                    proj_rows, prev_cost)
            else:
                H = H * (WtV / torch.clamp_min(WtW @ H, eps))
                H, W = row_l2_transfer(H, W)
        # ---- W update (nmfsc.m:192-233); the reference returns from an H
        # underflow before reaching it (nmfsc.m:170-174) ----
        if not w_fixed and not term:
            HHt, VHt = H @ H.T, V @ H.T
            if w_sparse:
                f_w = lambda Wn: gram_cost_w(v_sq, VHt, HHt, Wn)  # noqa: E731
                dW = W @ HHt - VHt
                W, step_w, term, _ = search(f_w, W, dW, step_w, proj_cols,
                                            f_w(W))  # nmfsc.m:197, a fresh begobj
            else:
                W = W * (VHt / torch.clamp_min(W @ HHt, eps))
        if term:  # the loop stops and trims this iteration's cost
            return (W, H, step_w, step_h, prev_cost, WtV, WtW), prev_cost, True
        c, WtV, WtW = cost(W, H)
        return (W, H, step_w, step_h, c, WtV, WtW), c, False

    return step, cost


def nmfsc(V, num_basis_elems: int, config: dict | None = None, **kwargs):
    """Hoyer sparse NMF.  Returns Result as (W, H, cost).

    Parameters (nmfsc.m:9-41): W_init, H_init, W_sparsity/H_sparsity in
    [0, 1] (Hoyer sparseness, clamped to 1 — nmfsc.m:90-92), W_fixed,
    H_fixed, maxiter (100), tolerance (1e-3), seed, dtype, eps, device,
    linesearch_width (None / "auto" / 0: sequential halving; J > 0:
    J halvings per batched round), resume_state ({"step_w", "step_h"}
    of an earlier run, whose W and H come as the inits: skips the initial
    projections).  V must be non-negative; it is rescaled by its max
    (nmfsc.m:57-62).  cost[0] is the initial cost (length maxiter+1
    semantics, nmfsc.m:137-139).

    ``dispatch`` None, "fused" and "phased" all run this solver (its
    outer loop already runs on the host); the phased dispatch's own keys
    are accepted and change nothing.  Matmuls run in full f32 whatever
    the caller's TF32 settings, which come back on return.  W and H are
    tensors on the run's device; resume_state holds floats.
    """
    cfg = merge_config(config, kwargs)
    dispatch = cfg.pop("dispatch", None)
    if dispatch not in (None, "fused", "phased"):
        raise ValueError(f"unknown dispatch {dispatch!r}; "
                         "use 'fused' (default) or 'phased'")
    reject_mesh(cfg)
    device = resolve_device(V, cfg.get("device"))
    dtype = resolve_dtype(V, cfg.get("dtype"))
    V = ingest_rescaled(V, dtype, device)  # nmfsc.m:57-62
    m, n = V.shape
    k = int(num_basis_elems)

    maxiter, tolerance, eps, gen = common_scalars(cfg)
    w_sp = min(float(cfg.get("W_sparsity", 0.0) or 0.0), 1.0)  # nmfsc.m:90-92
    h_sp = min(float(cfg.get("H_sparsity", 0.0) or 0.0), 1.0)

    W0 = cfg.get("W_init")
    W0 = (uniform_init(gen, (m, k), dtype, device, floor_eps=False) if W0 is None
          else as_tensor(W0, dtype, device))  # nmfsc.m:73-75
    H0 = cfg.get("H_init")
    if H0 is None:
        H0 = uniform_init(gen, (k, n), dtype, device, floor_eps=False)
        H0 = H0 / torch.sqrt(torch.sum(H0 * H0, dim=1, keepdim=True))  # nmfsc.m:78-81
    else:
        H0 = as_tensor(H0, dtype, device)

    l1_w = hoyer_l1_target(m, w_sp) if w_sp > 0 else 0.0
    l1_h = hoyer_l1_target(n, h_sp) if h_sp > 0 else 0.0
    # Continuation: factors of an earlier run are already feasible (a
    # re-projection is only fp-approximately idempotent and would perturb
    # the trajectory), and the stepsizes resume where they stopped
    # (nmfsc.m:147,178).  An empty dict is a fresh run.
    rs = cfg.get("resume_state") or None
    t = host_scalar_type(dtype)
    step_w = t(rs["step_w"] if rs is not None else 1.0)
    step_h = t(rs["step_h"] if rs is not None else 1.0)
    spec = (w_sp > 0, h_sp > 0, bool(cfg.get("W_fixed", False)),
            bool(cfg.get("H_fixed", False)), eps, l1_w, l1_h)
    search = make_search(resolve_width(cfg.get("linesearch_width")))
    with full_f32_matmul():
        if rs is None:
            if w_sp > 0:  # initial projection (nmfsc.m:93-96)
                W0 = project_rows(W0.T, l1_w, 1.0)[0].T
            if h_sp > 0:  # nmfsc.m:106-109
                H0 = project_rows(H0, l1_h, 1.0)[0]
        step, cost = _make_step(V, spec, search)
        c0, WtV, WtW = cost(W0, H0)
        out = looplib.run(step, (W0, H0, step_w, step_h, c0, WtV, WtW), maxiter,
                          tolerance, offset=1, initial_cost=c0, cost_dtype=dtype)
    W, H, step_w, step_h = out.state[:4]
    return Result(fields=("W", "H", "cost"), W=W, H=H,
                  cost=looplib.trim_cost(out, maxiter, offset=1),
                  n_iters=int(out.n_iters),
                  converged=bool(out.stopped) or bool(out.terminated),
                  resume_state={"step_w": float(step_w), "step_h": float(step_h)})
