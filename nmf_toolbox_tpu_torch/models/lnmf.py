"""Local NMF (Li et al. 2001): KL-based, with a column-sum-1 basis.

PyTorch counterpart of ``nmf_toolbox_tpu/models/lnmf.py`` (reference:
lnmf.m).  Kept from the reference: the sqrt H update (lnmf.m:81), the
column-sum normalization of W (lnmf.m:64,75), the <= form of both
comparisons of the stop rule, and a cost vector that is NOT trimmed on
early exit (lnmf.m:89-91).  The W-update denominator ones(m,n) @ H'
(lnmf.m:74) is a broadcast of H's row sums, and the constant V log V
part of the KL cost is computed once.
"""
from __future__ import annotations

import torch

from ..core import (Result, as_tensor, common_scalars, merge_config,
                    parse_cost_every, reject_mesh, resolve_device,
                    resolve_dtype, uniform_init)
from ..ops import loop as looplib
from ..ops.normalize import unit_sum_columns


def _make_step(V, eps, w_fixed, h_fixed, ce, maxiter):
    v_logv = torch.sum(V * torch.log(V)) - torch.sum(V)
    cadence = looplib.cost_cadence(ce, maxiter)

    def step(carry, i):
        W, H = carry[0], carry[1]
        if not w_fixed:
            V_hat = W @ H
            h_rowsum = torch.sum(H, dim=1)  # ones(m,n) @ H' (lnmf.m:74)
            W = W * (((V / V_hat) @ H.T) / torch.clamp_min(h_rowsum[None, :], eps))
            W = unit_sum_columns(W)
        if not h_fixed:
            V_hat = W @ H
            H = torch.sqrt(H * (W.T @ (V / V_hat)))  # lnmf.m:81

        def cost_fn():
            # The objective's V_hat is a third full matmul whose only
            # consumer is the stop rule, so cost_every > 1 skips it; run()
            # reads the inclusive <= rule on check iterations only (a
            # carried cost would satisfy 0 <= tol on every other one).
            V_hat = W @ H
            return v_logv - torch.sum(V * torch.log(V_hat)) + torch.sum(V_hat)

        return cadence((W, H), carry, i, cost_fn)

    return step


def lnmf(V, num_basis_elems: int, config: dict | None = None, **kwargs):
    """Local NMF; returns a :class:`Result` unpacking as (W, H, cost).

    Parameters (lnmf.m:96-134): W_init, H_init, W_fixed, H_fixed,
    maxiter (100), tolerance (1e-3).  Extras: dtype, seed, eps,
    cost_every (objective cadence; the inclusive stop rule is checked
    only on computed objectives), device (where a NumPy ``V`` goes;
    default the CUDA card).  ``mesh`` raises ``NotImplementedError``.
    W and H come back as tensors on the run's device; the cost trace
    keeps length maxiter, zero after an early stop.
    """
    cfg = merge_config(config, kwargs)
    reject_mesh(cfg)
    device = resolve_device(V, cfg.get("device"))
    dtype = resolve_dtype(V, cfg.get("dtype"))
    V = as_tensor(V, dtype, device)
    m, n = V.shape
    k = int(num_basis_elems)
    maxiter, tolerance, eps, gen = common_scalars(cfg)

    W0 = cfg.get("W_init")
    if W0 is None:
        W0 = unit_sum_columns(uniform_init(gen, (m, k), dtype, device))  # lnmf.m:112-113
    H0 = cfg.get("H_init")
    if H0 is None:
        H0 = uniform_init(gen, (k, n), dtype, device)
    W0 = unit_sum_columns(as_tensor(W0, dtype, device))  # lnmf.m:64
    H0 = as_tensor(H0, dtype, device)

    ce = parse_cost_every(cfg)
    with torch.no_grad():
        step = _make_step(V, eps, bool(cfg.get("W_fixed", False)),
                          bool(cfg.get("H_fixed", False)), ce, maxiter)
        out = looplib.run(step, looplib.cadence_state((W0, H0), ce, dtype),
                          maxiter, tolerance, inclusive=True, cost_dtype=dtype,
                          cost_every=ce)
    return Result(fields=("W", "H", "cost"), W=out.state[0], H=out.state[1],
                  cost=looplib.trim_cost(out, maxiter, trim=False),
                  n_iters=out.n_iters, converged=out.stopped)
