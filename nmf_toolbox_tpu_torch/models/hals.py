"""HALS NMF (Cichocki & Phan 2009).

PyTorch counterpart of ``nmf_toolbox_tpu/models/hals.py``, with the same
config surface, guards, stop rule and results.  Each sweep solves every
rank-1 subproblem exactly; its heavy work is the same two Gram products
as the multiplicative-update Gram path (V H' and W'V), plus k exact
column updates of W and k row updates of H in sequence.

Layout: the JAX ``fori_loop`` over columns becomes a Python loop of
small matrix-vector products (2k per sweep).  The columns of a row-major
(m, k) W are strided, so the solver carries W transposed, as a
contiguous (k, m) tensor whose rows it updates in place, and transposes
back once at the end.  The factors are copies: the caller's
``W_init``/``H_init`` are never written.
"""
from __future__ import annotations

import torch

from ..core import (Result, as_tensor, common_scalars, merge_config,
                    prepare_weights, resolve_device, resolve_dtype,
                    uniform_init)
from ..ops import loop as looplib
from ..ops.gram import euclidean_cost_gram, sq_norm
from ..ops.normalize import unit_l2_columns
from ..utils.init import nndsvd, seedable

# Ang & Gillis (2019) momentum constants (hals.py:168).
GAMMA, GAMMA_BAR, ETA = 1.05, 1.01, 1.5


def _copy(x):
    """A contiguous copy, which the sweeps may update in place."""
    return x.clone(memory_format=torch.contiguous_format)


def _sweep_rows(X, G, D, diag, eps):
    """One HALS sweep over the rows of X (k, p), in place, in order:
    x_j <- max(x_j + (d_j - g_j @ X) / diag_j, eps), where g_j = G[j]."""
    for j in range(X.shape[0]):  # three launches per row
        r = torch.addmv(D[j], X.T, G[j], alpha=-1)  # d_j - g_j @ X
        X[j].addcdiv_(r, diag[j]).clamp_min_(eps)


def _plain_step(V, v_sq, eps, inner):
    def step(carry, i):
        Wt, H = carry  # Wt: W transposed, (k, m)
        # W sweep.  V H' and H H' depend only on V and the fixed H, so
        # the sweep can repeat `inner` times reusing them (accelerated
        # HALS, Gillis & Glineur 2012).  Row j of HHt' is column j of
        # HHt, the JAX sweep's coefficient vector.
        HHt = H @ H.T
        VHt_t = H @ V.T                          # (V H')', [mnk]
        diagH = torch.clamp_min(torch.diagonal(HHt), eps)
        for _ in range(inner):
            _sweep_rows(Wt, HHt.T, VHt_t, diagH, eps)
        # H sweep.
        WtW = Wt @ Wt.T
        WtV = Wt @ V                             # [mnk]
        diagW = torch.clamp_min(torch.diagonal(WtW), eps)
        for _ in range(inner):
            _sweep_rows(H, WtW, WtV, diagW, eps)
        return (Wt, H), euclidean_cost_gram(v_sq, WtV, WtW, H), False
    return step


def _extrapolated_step(V, v_sq, eps, inner):
    """Extrapolated HALS (Ang & Gillis 2019, arXiv:1805.06604, Algorithm
    3 adapted): the sweeps run against extrapolated iterates
    Wy/Hy = X_new + beta (X_new - X_old); beta grows while the surrogate
    objective decreases, and a restart drops the momentum when it rises.
    The restart is a ``torch.where`` on 0-d tensors, so it adds no host
    sync."""
    def step(carry, i):
        Wt, H, Wyt, Hy, beta, beta_bar, prev_err = carry
        # H sweeps against the extrapolated basis Wy.
        WtW = Wyt @ Wyt.T
        WtV = Wyt @ V                            # [mnk]
        diagW = torch.clamp_min(torch.diagonal(WtW), eps)
        Hn = _copy(Hy)
        for _ in range(inner):
            _sweep_rows(Hn, WtW, WtV, diagW, eps)
        Hy_n = Hn + beta * (Hn - H)
        # W sweeps against the extrapolated encoding Hy_n.
        HHt = Hy_n @ Hy_n.T
        VHt_t = Hy_n @ V.T                       # [mnk]
        diagH = torch.clamp_min(torch.diagonal(HHt), eps)
        Wn = _copy(Wyt)
        for _ in range(inner):
            _sweep_rows(Wn, HHt.T, VHt_t, diagH, eps)
        Wy_n = Wn + beta * (Wn - Wt)
        # Surrogate objective 0.5||V - Wy Hn||^2 from the Grams already
        # computed: the restart signal and the reported trace.
        err = euclidean_cost_gram(v_sq, WtV, WtW, Hn)
        worse = err > prev_err
        beta_n = torch.where(worse, beta / ETA,
                             torch.minimum(beta_bar, beta * GAMMA))
        beta_bar_n = torch.where(worse, beta,
                                 torch.clamp_max(beta_bar * GAMMA_BAR, 1.0))
        Wy_n = torch.where(worse, Wn, Wy_n)
        Hy_n = torch.where(worse, Hn, Hy_n)
        return (Wn, Hn, Wy_n, Hy_n, beta_n, beta_bar_n, err), err, False
    return step


def _weighted_step(M, eps):
    """Weighted HALS: exact rank-1 coordinate solves of the per-entry
    weighted objective 0.5*sum(M * (V - W H)^2).

    The carry holds the unmasked residual R = V - W H (rank-1 updates to
    it are exact; a masked residual would square non-binary weights).
    For column j of W, with per-row denominators d_i = sum_l M_il h_jl^2:
    w_i <- max((((M*R) h_j)_i + w_ij d_i) / d_i, eps), then
    R -= outer(w_new - w_old, h_j); H's rows likewise.  Each column costs
    two O(mn) elementwise passes and a matrix-vector product.
    """
    def step(carry, i):
        Wt, H, R = carry
        Dw = torch.clamp_min((H * H) @ M.T, eps)        # (k, m): (M (H*H)')'
        for j in range(Wt.shape[0]):
            hj = H[j]
            w_new = torch.clamp_min(
                (torch.mv(M * R, hj) + Wt[j] * Dw[j]) / Dw[j], eps)
            R.addr_(w_new - Wt[j], hj, alpha=-1)
            Wt[j] = w_new
        Dh = torch.clamp_min((Wt * Wt) @ M, eps)        # (k, n)
        for j in range(H.shape[0]):
            wj = Wt[j]
            h_new = torch.clamp_min(
                (torch.mv((M * R).T, wj) + H[j] * Dh[j]) / Dh[j], eps)
            R.addr_(wj, h_new - H[j], alpha=-1)
            H[j] = h_new
        return (Wt, H, R), 0.5 * torch.sum(M * R * R), False
    return step


def nmf_hals(V, num_basis_elems: int, config: dict | None = None, **kwargs):
    """Euclidean NMF via HALS.  Returns a :class:`Result` unpacking as
    (W, H, cost).

    Parameters as ``nmf_toolbox_tpu.nmf_hals``: ``W_init``, ``H_init``
    (used as given: a user W is not renormalized, unlike in ``nmf``),
    ``init`` ('random' | 'nndsvd' | 'nndsvda' | 'nndsvdar'), ``maxiter``
    (100), ``tolerance`` (1e-3), ``seed``, ``dtype``, ``eps``,
    ``inner_iters`` (sweep repetitions per factor), ``extrapolate``
    (Ang & Gillis momentum; its cost trace is the surrogate
    0.5||V - Wy H||^2, the factors are the feasible iterates),
    ``resume_state`` (the momentum state a previous extrapolated run
    returned, so chunked runs continue exactly) and ``weights`` ((m, n)
    nonnegative per-entry weights).  The stop rule is inclusive: HALS can
    drive the clamped Gram cost to exactly 0, where a strict rule could
    never fire.

    ``device``: where a NumPy ``V`` goes (default: the CUDA card; with no
    card the call raises, so pass ``"cpu"`` to run on the CPU); a tensor
    ``V`` runs on its own device.  ``mesh`` is not ported yet and raises
    ``NotImplementedError``.  With ``extrapolate=True``,
    ``Result.resume_state`` holds ``Wy``/``Hy`` (tensors on the run's
    device) and ``beta``, ``beta_bar``, ``prev_err`` (floats).
    """
    cfg = merge_config(config, kwargs)
    if cfg.get("mesh") is not None:
        raise NotImplementedError(
            "mesh= is not ported to nmf_toolbox_tpu_torch yet "
            "(ROADMAP queue 1 item 13 (multi-GPU))")
    device = resolve_device(V, cfg.get("device"))
    dtype = resolve_dtype(V, cfg.get("dtype"))
    V = as_tensor(V, dtype, device)
    m, n = V.shape
    k = int(num_basis_elems)
    maxiter, tolerance, eps, gen = common_scalars(cfg)
    weights = cfg.get("weights")

    W0 = cfg.get("W_init")
    H0 = cfg.get("H_init")
    init = str(cfg.get("init", "random"))
    if init != "random":
        if init not in ("nndsvd", "nndsvda", "nndsvdar"):
            raise ValueError(f"unknown init {init!r}; expected 'random', "
                             "'nndsvd', 'nndsvda', or 'nndsvdar'")
        if W0 is not None or H0 is not None:
            raise ValueError("init='nndsvd*' cannot be combined with "
                             "W_init/H_init")
        cdt = torch.promote_types(dtype, torch.float32)
        Vs = seedable(V) if weights is not None else V
        W0, H0 = nndsvd(Vs.to(cdt), k, generator=gen, variant=init)
    if W0 is None:
        W0 = unit_l2_columns(uniform_init(gen, (m, k), dtype, device))
    if H0 is None:
        H0 = uniform_init(gen, (k, n), dtype, device)
    W0 = as_tensor(W0, dtype, device)
    H0 = as_tensor(H0, dtype, device)
    if tuple(W0.shape) != (m, k) or tuple(H0.shape) != (k, n):
        raise ValueError(f"W_init/H_init have shapes {tuple(W0.shape)}, "
                         f"{tuple(H0.shape)}; expected {(m, k)}, {(k, n)}")

    inner = cfg.get("inner_iters", 1)
    inner = 1 if inner is None else int(inner)
    if inner < 1:
        raise ValueError("inner_iters must be >= 1")
    extrapolate = bool(cfg.get("extrapolate", False))
    Wt0, H0 = _copy(W0.T), _copy(H0)
    run = dict(cost_dtype=dtype, inclusive=True)
    resume_state = None
    with torch.no_grad():
        if weights is not None:
            if extrapolate:
                raise ValueError("extrapolate=True is not supported together "
                                 "with weights=")
            if inner != 1:
                raise ValueError("inner_iters > 1 is not supported with "
                                 "weights= (the masked residual changes "
                                 "every sweep)")
            M = prepare_weights(weights, dtype, device, (m, n))
            V = torch.where(M > 0, V, torch.zeros((), dtype=dtype, device=device))
            out = looplib.run(_weighted_step(M, eps),
                              (Wt0, H0, V - Wt0.T @ H0), maxiter, tolerance,
                              **run)
        elif extrapolate:
            rs = cfg.get("resume_state") or None
            if rs is not None:
                mom = (_copy(as_tensor(rs["Wy"], dtype, device).T),
                       as_tensor(rs["Hy"], dtype, device))
                scalars = (rs["beta"], rs["beta_bar"], rs["prev_err"])
            else:
                mom = (Wt0, H0)
                scalars = (0.5, 1.0, torch.finfo(dtype).max)
            mom += tuple(torch.tensor(float(x), dtype=dtype, device=device)
                         for x in scalars)
            out = looplib.run(_extrapolated_step(V, sq_norm(V), eps, inner),
                              (Wt0, H0) + mom, maxiter, tolerance, **run)
            st = out.state
            resume_state = {"Wy": st[2].T.contiguous(), "Hy": st[3],
                            "beta": float(st[4]), "beta_bar": float(st[5]),
                            "prev_err": float(st[6])}
        else:
            out = looplib.run(_plain_step(V, sq_norm(V), eps, inner),
                              (Wt0, H0), maxiter, tolerance, **run)
    Wt, H = out.state[0], out.state[1]
    return Result(fields=("W", "H", "cost"),
                  W=Wt.T.contiguous(), H=H,
                  cost=looplib.trim_cost(out, maxiter),
                  n_iters=out.n_iters, converged=out.stopped,
                  resume_state=resume_state)
