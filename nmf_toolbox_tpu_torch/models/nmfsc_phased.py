"""Phase-split nmfsc dispatch: bounded device work, speculative blocks.

PyTorch counterpart of ``nmf_toolbox_tpu/models/nmfsc_phased.py``
(``nmfsc(..., dispatch="phased")``).  The default solver
(``models/nmfsc.py``) runs its line searches and projections as host
loops: one read per trial and one per group of projection passes.  Here
every piece of an iteration has a bound fixed before it runs, so an
iteration reads nothing back:

* a line search is ``trials`` sequential trials with acceptance masks
  (:func:`_bounded_search`), or one round of ``trials`` candidates
  evaluated side by side (:func:`_batched_round`); masked trials are
  exact no-ops, so a search that neither accepts nor underflows within
  them is simply continued;
* every trial projects with ``ops/projection.project_rows_bounded``, on
  the card one launch of the hand-written kernel ``csrc/hoyer.cu``;
* the fused iteration (:func:`_phases` ``iter_step``: H phase, W phase,
  cost) packs its eight flags and the cost into one tensor, and the host
  enqueues ``spec_ahead`` iterations and reads their flags in ONE stacked
  read.  A stop, an underflow or a search that needs more than
  ``trials`` halvings is handled in order from the flags; the speculated
  work past it is dropped, and the last case redoes that iteration from
  its entry state through the per-phase slow path, whose continuation
  rounds read once each.

Stepsizes stay 0-d tensors of the factor's dtype on the run's device;
their f32 updates round as the default solver's host scalars do.  The
trajectory (W, H, cost, n_iters, converged, resume_state) equals the
default solver's bit for bit on the CPU: the same products, sums and
decisions in the same order, split differently.  Single-device only.

Reference semantics: nmfsc.m:141-245 (line searches nmfsc.m:152-179 /
196-233, underflow return nmfsc.m:170-174, MU fallbacks nmfsc.m:182-187,
cost nmfsc.m:237-243); projection projfunc.m:28-55.
"""
from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple

import numpy as np
import torch

from ..core import (Result, common_scalars, full_f32_matmul, host_read,
                    ingest_rescaled, merge_config, resolve_device, resolve_dtype)
from ..ops.linesearch import host_scalar_type, resolve_width, underflow_threshold
from ..ops.normalize import row_l2_transfer
from ..ops.projection import project_rows_bounded
from .nmfsc import gram_cost, gram_cost_w, initial_factors, sparsity_targets

PROJ_ERROR = ("bounded Hoyer projection did not converge within proj_passes "
              "passes{}; raise nmfsc(..., proj_passes=)")
FLAGS = ("h_acc", "h_und", "h_more", "w_acc", "w_und", "w_more", "proj_ok")


class _PhSpec(NamedTuple):
    w_sparse: bool
    h_sparse: bool
    w_fixed: bool
    h_fixed: bool
    eps: float
    l1_w: float
    l1_h: float
    trials: int       # line-search trials per round
    proj_passes: int  # Hoyer projection passes per trial (bounded)
    batched: bool = False  # a round's candidates side by side


def _bounded_search(obj_fn, X, dX, step0, project, begobj, trials: int):
    """``trials`` trials of the backtracking search (nmfsc.m:152-179), run
    in turn with acceptance masks, trial for trial the decisions of
    ``ops/linesearch.backtracking_search``.  Returns (X_out, step_out,
    accepted, underflow, proj_ok), all tensors; neither accepted
    nor underflow means the caller continues from the returned (halved)
    step, since every trial starts from the same X."""
    dev = X.device
    thr = underflow_threshold(X.dtype)
    accepted = underflow = torch.zeros((), dtype=torch.bool, device=dev)
    proj_ok = torch.ones((), dtype=torch.bool, device=dev)
    step, Xb = step0, X
    for _ in range(trials):
        active = ~accepted & ~underflow
        Xnew, done = project(X - step * dX)
        newobj = obj_fn(Xnew)
        acc = newobj <= begobj
        step_next = torch.where(acc, step, step / 2.0)
        under = ~acc & (step_next < thr)
        step = torch.where(active, step_next, step)
        Xb = torch.where(active & acc, Xnew, Xb)
        accepted = accepted | (active & acc)
        underflow = underflow | (active & under)
        proj_ok = proj_ok & (~active | torch.all(done))
    return (torch.where(accepted, Xb, X), torch.where(accepted, 1.2 * step, step),
            accepted, underflow, proj_ok)


def _batched_round(obj_fn, X, dX, step0, project, begobj, width: int, halvings):
    """One round of ``width`` successive halvings projected and evaluated
    side by side (``halvings`` = 0.5 ** arange(width) in X's dtype): the
    FIRST candidate that does not increase the objective wins, and an
    underflow strictly before it pre-empts it, the selection of
    ``ops/linesearch.parallel_backtracking_search``.  Returns what
    :func:`_bounded_search` returns; a round that neither accepts nor
    underflows continues from the last candidate's half step."""
    dev = X.device
    steps = step0 * halvings
    Xp, done = project(X - steps.reshape((-1,) + (1,) * X.ndim) * dX)
    objs = obj_fn(Xp)
    acc = objs <= begobj
    under = (steps / 2.0) < underflow_threshold(X.dtype)
    j_acc, j_und = acc.to(torch.uint8).argmax(), under.to(torch.uint8).argmax()
    any_und = under.any()
    accepted = acc.any() & (~any_und | (j_acc <= j_und))
    underflow = any_und & ~accepted
    last = torch.full((), width - 1, dtype=j_acc.dtype, device=dev)
    j = torch.where(accepted, j_acc, torch.where(underflow, j_und, last)).reshape(1)
    s_j = steps.index_select(0, j)[0]
    step_out = torch.where(accepted, 1.2 * s_j,
                           torch.where(underflow, s_j, steps[-1]) / 2.0)
    # a sequential search would have projected only candidates 0..j
    ran = torch.arange(width, device=dev) <= j
    proj_ok = torch.all(done | ~ran.reshape((-1,) + (1,) * (done.ndim - 1)))
    return (torch.where(accepted, Xp.index_select(0, j)[0], X), step_out,
            accepted, underflow, proj_ok)


def _phases(spec: _PhSpec, V, v_sq):
    """The phase functions of one run, closures over V and ||V||^2; the
    products and sums are those of ``models/nmfsc._make_step``."""
    dt, dev = V.dtype, V.device
    eps = spec.eps
    if spec.batched:
        halvings = torch.tensor([0.5 ** j for j in range(spec.trials)], dtype=dt, device=dev)
        search = partial(_batched_round, halvings=halvings)
    else:
        search = _bounded_search

    def proj_rows(H):
        return project_rows_bounded(H, spec.l1_h, 1.0, spec.proj_passes)

    def proj_cols(W):
        v, done = project_rows_bounded(W.mT, spec.l1_w, 1.0, spec.proj_passes)
        return v.mT, done

    def cost(W, H):
        """The clamped cost of (W, H) and the Grams W'V, W'W it formed,
        which the next H phase reuses."""
        WtV, WtW = W.T @ V, W.T @ W
        return torch.clamp_min(gram_cost(v_sq, WtV, WtW, H), 0.0), WtV, WtW

    def h_round(WtV, WtW, H, step_h):
        dH = WtW @ H - WtV

        def obj(Hn):
            return gram_cost(v_sq, WtV, WtW, Hn)
        # begobj is the previous cost (nmfsc.m:148), clamped as the
        # default solver carries it; W has not moved since it was taken.
        return search(obj, H, dH, step_h, proj_rows, torch.clamp_min(obj(H), 0.0),
                      spec.trials)

    def h_mu(W, H, WtV, WtW):
        H = H * (WtV / torch.clamp_min(WtW @ H, eps))
        H, W = row_l2_transfer(H, W)
        return W, H

    def w_grams(H):
        return H @ H.T, V @ H.T

    def w_round(HHt, VHt, W, step_w):
        dW = W @ HHt - VHt

        def obj(Wn):
            return gram_cost_w(v_sq, VHt, HHt, Wn)
        return search(obj, W, dW, step_w, proj_cols, obj(W), spec.trials)  # nmfsc.m:197

    def w_mu(W, HHt, VHt):
        return W * (VHt / torch.clamp_min(W @ HHt, eps))

    def iter_step(W, H, step_w, step_h, WtV, WtW):
        """One whole iteration, reading nothing back: each search gets
        one round, and a search that neither accepts nor underflows in it
        sets h_more / w_more, which sends the host to the slow path from
        this iteration's entry state.  Returns the new state and the
        flags of FLAGS and the cost, stacked in the factors' dtype."""
        no = torch.zeros((), dtype=torch.bool, device=dev)
        h_acc = h_und = h_more = w_acc = w_und = w_more = no
        pok1 = pok2 = ~no
        if not spec.h_fixed:
            if spec.h_sparse:
                H1, sh1, h_acc, h_und, pok1 = h_round(WtV, WtW, H, step_h)
                h_more = ~h_acc & ~h_und
                H = H1  # H unless accepted
                # an underflow commits the halved step, as the search does
                step_h = torch.where(h_acc | h_und, sh1, step_h)
            else:
                W, H = h_mu(W, H, WtV, WtW)
        term = h_und  # the reference returns before the W phase
        if not spec.w_fixed:
            HHt, VHt = w_grams(H)
            if spec.w_sparse:
                W1, sw1, w_acc, w_und, pok2 = w_round(HHt, VHt, W, step_w)
                w_more = ~term & ~w_acc & ~w_und
                w_und = ~term & w_und
                use = ~term & w_acc
                W = torch.where(use, W1, W)
                step_w = torch.where(use | w_und, sw1, step_w)
            else:
                W = torch.where(term, W, w_mu(W, HHt, VHt))
        c, WtV, WtW = cost(W, H)
        # Projection flags count only for results the host keeps: a redo
        # re-checks in the slow path, and an H underflow drops the W phase.
        pok = (h_more | w_more) | (pok1 & (h_und | pok2))
        flags = torch.stack([f.to(dt) for f in (h_acc, h_und, h_more, w_acc, w_und,
                                                w_more, pok)] + [c])
        return (W, H, step_w, step_h, WtV, WtW), flags

    def search_to_accept(round_fn, grams, X, step):
        """Rounds of ``round_fn`` from X until one accepts or underflows
        (the unbounded search of nmfsc.m:152-175), one read per round.
        The budget covers halving from the first step to the underflow
        threshold even at one trial a round.  Returns (X, step, underflow)."""
        thr = underflow_threshold(dt)
        budget, rounds = None, 0
        while True:
            X_out, step_out, accepted, underflow, proj_ok = round_fn(*grams, X, step)
            ok, acc, und, s0 = host_read(torch.stack(
                [proj_ok.to(dt), accepted.to(dt), underflow.to(dt), step]))
            if budget is None:
                budget = int(math.log2(max(s0, thr)) - math.log2(thr)) + 8
            if not ok:
                raise RuntimeError(PROJ_ERROR.format(""))
            if acc or und:
                return X_out, step_out, bool(und)
            rounds += 1
            if rounds >= budget:
                raise RuntimeError("line search exceeded its round budget without "
                                   f"acceptance or underflow (stepsize {s0!r})")
            step = step_out

    def slow_iteration(W, H, step_w, step_h, WtV, WtW):
        """One iteration through the per-phase path with unbounded
        continuation rounds.  Returns (state, terminated, cost as a host
        float or None)."""
        term = False
        if not spec.h_fixed:
            if spec.h_sparse:
                H, step_h, term = search_to_accept(h_round, (WtV, WtW), H, step_h)
            else:
                W, H = h_mu(W, H, WtV, WtW)
        if not term and not spec.w_fixed:
            HHt, VHt = w_grams(H)
            if spec.w_sparse:
                W, step_w, term = search_to_accept(w_round, (HHt, VHt), W, step_w)
            else:
                W = w_mu(W, HHt, VHt)
        if term:
            return (W, H, step_w, step_h, WtV, WtW), True, None
        c, WtV, WtW = cost(W, H)
        return (W, H, step_w, step_h, WtV, WtW), False, host_read(c)

    return cost, iter_step, slow_iteration


def nmfsc_phased(V, num_basis_elems: int, config: dict | None = None, **kwargs):
    """nmfsc with the phase-split dispatch (see the module docstring).

    The parameters of ``models/nmfsc.nmfsc`` minus ``mesh`` (a mesh
    raises ValueError: single-device), plus ``trials`` (trials per
    round; default 24, or ``linesearch_width`` when that is > 0),
    ``proj_passes`` (bounded projection passes per trial, default 48; too
    few raise RuntimeError), ``fuse_iteration`` (default True: whole
    iterations in speculative blocks; False: the per-phase path every
    iteration), ``spec_ahead`` (iterations per block, default 4) and
    ``batched_trials`` (a round's candidates side by side; default
    ``linesearch_width > 0``).  Returns Result(W, H, cost) as nmfsc does.
    """
    cfg = merge_config(config, kwargs)
    if cfg.get("mesh") is not None:
        raise ValueError("dispatch='phased' is single-device; drop mesh=")
    device = resolve_device(V, cfg.get("device"))
    dtype = resolve_dtype(V, cfg.get("dtype"))
    V = ingest_rescaled(V, dtype, device)  # nmfsc.m:57-62
    m, n = V.shape
    k = int(num_basis_elems)
    maxiter, tolerance, eps, gen = common_scalars(cfg)
    w_sp, h_sp, l1_w, l1_h = sparsity_targets(cfg, m, n)
    W, H = initial_factors(cfg, gen, m, n, k, dtype, device)
    t = host_scalar_type(dtype)  # the trace and the stop rule round in the cost dtype
    tol = t(tolerance)

    lw = resolve_width(cfg.get("linesearch_width"))
    spec = _PhSpec(w_sp > 0, h_sp > 0, bool(cfg.get("W_fixed", False)),
                   bool(cfg.get("H_fixed", False)), eps, float(l1_w), float(l1_h),
                   int(cfg.get("trials", lw if lw > 0 else 24)),
                   int(cfg.get("proj_passes", 48)),
                   bool(cfg.get("batched_trials", lw > 0)))
    # An empty dict is a fresh run; resumed factors are already feasible.
    rs = cfg.get("resume_state") or None
    step_w, step_h = (torch.tensor(float(rs[key]) if rs is not None else 1.0,
                                   dtype=dtype, device=device)
                      for key in ("step_w", "step_h"))
    use_fused = bool(cfg.get("fuse_iteration", True))
    spec_ahead = max(1, int(cfg.get("spec_ahead", 4))) if use_fused else 1

    with full_f32_matmul():
        proj_ok = []
        if rs is None:
            if spec.w_sparse:  # initial projection (nmfsc.m:93-96)
                v, ok = project_rows_bounded(W.T, l1_w, 1.0, spec.proj_passes)
                W = v.T
                proj_ok.append(torch.all(ok))
            if spec.h_sparse:  # nmfsc.m:106-109
                H, ok = project_rows_bounded(H, l1_h, 1.0, spec.proj_passes)
                proj_ok.append(torch.all(ok))
        cost, iter_step, slow_iteration = _phases(spec, V, torch.sum(V * V))
        c0, WtV, WtW = cost(W, H)
        # one read: the initial cost (nmfsc.m:137-139) and the projections' flags
        head = host_read(torch.stack([c0] + [ok.to(dtype) for ok in proj_ok]))
        if not all(head[1:]):
            raise RuntimeError(PROJ_ERROR.format(" on the initial factors"))
        trace = [t(head[0])]

        def stops(i, c):
            """Record iteration i's cost (i counts from 1); the stop rule
            from the second iteration on (nmf.m:221-224)."""
            trace.append(t(c))
            return i >= 2 and trace[-1] < trace[-2] and trace[-2] - trace[-1] < tol

        state = (W, H, step_w, step_h, WtV, WtW)
        i = n_iters = 0
        terminated = stopped = False
        while i < maxiter and not (terminated or stopped):
            if not use_fused:
                n_iters = i = i + 1
                state, terminated, c = slow_iteration(*state)
                stopped = not terminated and stops(i, c)
                continue
            # Speculative block: enqueue whole iterations back to back and
            # read all their flags at once.
            pre, post, outs, s = [], [], [], state
            for _ in range(min(spec_ahead, maxiter - i)):
                pre.append(s)
                s, fl = iter_step(*s)
                post.append(s)
                outs.append(fl)
            for b, fl in enumerate(host_read(torch.stack(outs))):
                f = dict(zip(FLAGS, map(bool, fl[:7])))
                if not f["proj_ok"]:
                    raise RuntimeError(PROJ_ERROR.format(""))
                n_iters = i = i + 1
                if f["h_more"] or f["w_more"]:
                    # a search needs more than `trials` halvings: redo this
                    # iteration from its entry state; the rest is stale
                    state, terminated, c = slow_iteration(*pre[b])
                    stopped = not terminated and stops(i, c)
                    break
                state = post[b]
                if f["h_und"] or f["w_und"]:
                    terminated = True  # this iteration's cost is dropped
                    break
                stopped = stops(i, fl[7])
                if stopped:
                    break
        W, H, step_w, step_h = state[:4]
        steps = host_read(torch.stack([step_w, step_h]))
    return Result(fields=("W", "H", "cost"), W=W, H=H, cost=np.stack(trace),
                  n_iters=n_iters, converged=stopped or terminated,
                  resume_state={"step_w": steps[0], "step_h": steps[1]})
