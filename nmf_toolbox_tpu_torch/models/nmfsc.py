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

Under a mesh (``parallel.placements_for("nmfsc")``) V is zero-padded and
sharded like nmf's; the Grams W'V, W'W sum over features and H H', V H'
over samples; the Hoyer projections sum each vector over the axis it is
sharded along (H's rows over samples, W's columns over features) with
the true length as ``valid``; and every objective a search compares
sums over every rank, so each rank accepts the same trial and reads the
same flags.  The initial projections run on the whole factors before
placement, as in the JAX package.
"""
from __future__ import annotations

import torch

from ..core import (Result, as_tensor, common_scalars, full_f32_matmul,
                    ingest_rescaled, merge_config, resolve_device,
                    resolve_dtype, staging_device, uniform_init)
from ..ops import loop as looplib
from ..ops.linesearch import host_scalar_type, make_search, resolve_width
from ..ops.normalize import row_l2_transfer
from ..ops.projection import hoyer_l1_target, project_rows
from ..parallel.collectives import gather_factor, sum_all, sum_features, sum_samples
from ..parallel.mesh import apply_placements, check_mesh
from ..parallel.padding import pad_axes, plan_padding

MATRIX = (-2, -1)  # a candidate's factor: the objective sums over these


def gram_cost(v_sq, WtV, WtW, H, mesh=None):
    """0.5||V - W H||^2 = 0.5(||V||^2 - 2<W'V, H> + <W'W H, H>) per
    candidate H (..., k, n), in the JAX package's association.  ``mesh``:
    H holds this rank's columns (the Grams summed over features), and
    both inner products sum over samples."""
    lin, sq = torch.sum(WtV * H, dim=MATRIX), torch.sum((WtW @ H) * H, dim=MATRIX)
    if mesh is not None:
        lin, sq = sum_samples(mesh, lin, sq)
    return 0.5 * (v_sq - 2.0 * lin + sq)


def gram_cost_w(v_sq, VHt, HHt, W, mesh=None):
    """The same objective for candidates W (..., m, k) with H frozen;
    ``mesh``: W holds this rank's rows, and <V H', W> and W'W sum over
    features."""
    lin, WtW = torch.sum(VHt * W, dim=MATRIX), W.mT @ W
    if mesh is not None:
        lin, WtW = sum_features(mesh, lin, WtW)
    return 0.5 * (v_sq - 2.0 * lin + torch.sum(WtW * HHt, dim=MATRIX))


def _make_step(V, spec, search, valid=None, mesh=None):
    """``(step, cost)``: one iteration on the state (W, H, step_w,
    step_h, cost, W'V, W'W), and the clamped cost of (W, H) with the
    Grams it formed.  The Grams of the committed W ride the state into
    the next H update, which JAX forms anew: the same products, one
    m-by-n GEMM fewer per iteration.  ``valid``: the true (m, n) of a
    mesh-padded V, the projections' vector lengths."""
    w_sparse, h_sparse, w_fixed, h_fixed, eps, l1_w, l1_h = spec
    mv, nv = (None, None) if valid is None else valid
    v_sq = sum_all(mesh, torch.sum(V * V))

    def proj_rows(H):
        return project_rows(H, l1_h, 1.0, nv, mesh, "n")[0]

    def proj_cols(W):
        return project_rows(W.mT, l1_w, 1.0, mv, mesh, "m")[0].mT

    def cost(W, H):
        # clamp: see ops/gram.euclidean_cost_gram (nmfsc.m:237-238)
        WtV, WtW = sum_features(mesh, W.T @ V, W.T @ W)
        return torch.clamp_min(gram_cost(v_sq, WtV, WtW, H, mesh), 0.0), WtV, WtW

    def step(state, i):
        W, H, step_w, step_h, prev_cost, WtV, WtW = state
        term = False
        # ---- H update (nmfsc.m:143-189) ----
        if not h_fixed:
            if h_sparse:
                dH = WtW @ H - WtV  # positive_grad - negative_grad
                H, step_h, term, _ = search(
                    lambda Hn: gram_cost(v_sq, WtV, WtW, Hn, mesh), H, dH, step_h,
                    proj_rows, prev_cost)
            else:
                H = H * (WtV / torch.clamp_min(WtW @ H, eps))
                H, W = row_l2_transfer(H, W, mesh)
        # ---- W update (nmfsc.m:192-233); the reference returns from an H
        # underflow before reaching it (nmfsc.m:170-174) ----
        if not w_fixed and not term:
            HHt, VHt = sum_samples(mesh, H @ H.T, V @ H.T)
            if w_sparse:
                f_w = lambda Wn: gram_cost_w(v_sq, VHt, HHt, Wn, mesh)  # noqa: E731
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


def sparsity_targets(cfg, m: int, n: int) -> tuple:
    """(w_sp, h_sp, l1_w, l1_h): the sparseness of each factor clamped to
    1 (nmfsc.m:90-92) and its L1 target for unit-L2 vectors, 0 where the
    factor is not sparse (nmfsc.m:93,106)."""
    w_sp = min(float(cfg.get("W_sparsity", 0.0) or 0.0), 1.0)
    h_sp = min(float(cfg.get("H_sparsity", 0.0) or 0.0), 1.0)
    return (w_sp, h_sp, hoyer_l1_target(m, w_sp) if w_sp > 0 else 0.0,
            hoyer_l1_target(n, h_sp) if h_sp > 0 else 0.0)


def initial_factors(cfg, gen, m: int, n: int, k: int, dtype, device) -> tuple:
    """(W0, H0): the caller's inits, or uniform draws with H's rows at
    unit L2 (nmfsc.m:73-81)."""
    W0 = cfg.get("W_init")
    W0 = (uniform_init(gen, (m, k), dtype, device, floor_eps=False) if W0 is None
          else as_tensor(W0, dtype, device))
    H0 = cfg.get("H_init")
    if H0 is None:
        H0 = uniform_init(gen, (k, n), dtype, device, floor_eps=False)
        return W0, H0 / torch.sqrt(torch.sum(H0 * H0, dim=1, keepdim=True))
    return W0, as_tensor(H0, dtype, device)


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

    ``dispatch`` None and "fused" run this solver; "phased" runs
    ``models/nmfsc_phased.py`` (bounded trial rounds, speculative blocks
    of iterations read once each, the bounded projection as one kernel
    launch; single-device, its own keys ``trials``, ``proj_passes``,
    ``fuse_iteration``, ``spec_ahead``, ``batched_trials``), bit-identical
    to this solver on the CPU.  Matmuls run in full f32 whatever
    the caller's TF32 settings, which come back on return.  ``mesh``
    (``parallel.make_mesh``): every rank calls with the same arguments
    and gets the whole W and H; ``linesearch_width`` "auto" stays 0 on a
    mesh too.  W and H are tensors on the run's device; resume_state
    holds floats.
    """
    cfg = merge_config(config, kwargs)
    dispatch = cfg.pop("dispatch", None)
    if dispatch == "phased":  # refuses a mesh before check_mesh, as JAX does
        from .nmfsc_phased import nmfsc_phased
        return nmfsc_phased(V, num_basis_elems, cfg)
    if dispatch not in (None, "fused"):
        raise ValueError(f"unknown dispatch {dispatch!r}; "
                         "use 'fused' (default) or 'phased'")
    mesh = check_mesh(cfg.get("mesh"))
    device = resolve_device(V, cfg.get("device"), mesh)
    dtype = resolve_dtype(V, cfg.get("dtype"))
    src = staging_device(V, device, mesh)  # the whole arrays until placement
    V = ingest_rescaled(V, dtype, src)  # nmfsc.m:57-62
    m, n = V.shape
    k = int(num_basis_elems)

    maxiter, tolerance, eps, gen = common_scalars(cfg)
    w_sp, h_sp, l1_w, l1_h = sparsity_targets(cfg, m, n)
    W0, H0 = initial_factors(cfg, gen, m, n, k, dtype, src)
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
        pad_m, pad_n, valid = plan_padding(mesh, m, n)
        if valid is not None:
            V = pad_axes(V, {0: pad_m, 1: pad_n})
            W0 = pad_axes(W0, {0: pad_m})
            H0 = pad_axes(H0, {1: pad_n})
        V, W0, H0 = apply_placements(mesh, "nmfsc", V=V, W=W0, H=H0)
        step, cost = _make_step(V, spec, search, valid, mesh)
        c0, WtV, WtW = cost(W0, H0)
        out = looplib.run(step, (W0, H0, step_w, step_h, c0, WtV, WtW), maxiter,
                          tolerance, offset=1, initial_cost=c0, cost_dtype=dtype)
    W, H, step_w, step_h = out.state[:4]
    W = gather_factor(mesh, W, "m", 0)[:m]
    H = gather_factor(mesh, H, "n", 1)[:, :n]
    return Result(fields=("W", "H", "cost"), W=W, H=H,
                  cost=looplib.trim_cost(out, maxiter, offset=1),
                  n_iters=int(out.n_iters),
                  converged=bool(out.stopped) or bool(out.terminated),
                  resume_state={"step_w": float(step_w), "step_h": float(step_h)})
