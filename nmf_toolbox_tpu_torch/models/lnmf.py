"""Local NMF (Li et al. 2001): KL-based, with a column-sum-1 basis.

PyTorch counterpart of ``nmf_toolbox_tpu/models/lnmf.py`` (reference:
lnmf.m).  Kept from the reference: the sqrt H update (lnmf.m:81), the
column-sum normalization of W (lnmf.m:64,75), the <= form of both
comparisons of the stop rule, and a cost vector that is NOT trimmed on
early exit (lnmf.m:89-91).  The W-update denominator ones(m,n) @ H'
(lnmf.m:74) is a broadcast of H's row sums, and the constant V log V
part of the KL cost is computed once.

Under a mesh each rank holds its block of V, its rows of W and its
columns of H (``parallel.placements_for("lnmf")``): V H' and H's row sums
sum over samples, W'(V/V_hat) and W's column sums over features, and the
cost over every rank, with the pad of a padded problem masked where its
0 log 0 or 0/0 would reach a sum.  Every rank reads the same reduced
cost, so the inclusive stop rule takes the same decision on each.
"""
from __future__ import annotations

import torch

from ..core import (Result, as_tensor, common_scalars, merge_config,
                    parse_cost_every, resolve_device, resolve_dtype,
                    staging_device, uniform_init)
from ..ops import loop as looplib
from ..ops.masking import region_mask
from ..ops.normalize import unit_sum_columns
from ..parallel.collectives import gather_factor, sum_all, sum_features, sum_samples
from ..parallel.mesh import apply_placements, block_offset, check_mesh
from ..parallel.padding import pad_axes, plan_padding


def _make_step(V, eps, w_fixed, h_fixed, ce, maxiter, valid=None, mesh=None):
    offset = (block_offset(mesh, V.shape[0], "m"), block_offset(mesh, V.shape[1]))
    mask = region_mask(V.shape, valid, V.device, offset)
    zero = torch.zeros((), dtype=V.dtype, device=V.device)

    def masked(x):
        return x if mask is None else torch.where(mask, x, zero)

    v_logv = sum_all(mesh, torch.sum(masked(V * torch.log(V))) - torch.sum(V))
    cadence = looplib.cost_cadence(ce, maxiter)

    def step(carry, i):
        W, H = carry[0], carry[1]
        if not w_fixed:
            V_hat = W @ H
            # ones(m,n) @ H' (lnmf.m:74) is H's row sums
            VHt, h_rowsum = sum_samples(mesh, masked(V / V_hat) @ H.T,
                                        torch.sum(H, dim=1))
            W = W * (VHt / torch.clamp_min(h_rowsum[None, :], eps))
            W = unit_sum_columns(W, mesh)
        if not h_fixed:
            V_hat = W @ H
            H = torch.sqrt(H * sum_features(mesh, W.T @ masked(V / V_hat)))  # lnmf.m:81

        def cost_fn():
            # The objective's V_hat is a third full matmul whose only
            # consumer is the stop rule, so cost_every > 1 skips it; run()
            # reads the inclusive <= rule on check iterations only (a
            # carried cost would satisfy 0 <= tol on every other one).
            V_hat = W @ H
            vlv, s = sum_all(mesh, torch.sum(masked(V * torch.log(V_hat))),
                             torch.sum(V_hat))
            return v_logv - vlv + s

        return cadence((W, H), carry, i, cost_fn)

    return step


def lnmf(V, num_basis_elems: int, config: dict | None = None, **kwargs):
    """Local NMF; returns a :class:`Result` unpacking as (W, H, cost).

    Parameters (lnmf.m:96-134): W_init, H_init, W_fixed, H_fixed,
    maxiter (100), tolerance (1e-3).  Extras: dtype, seed, eps,
    cost_every (objective cadence; the inclusive stop rule is checked
    only on computed objectives), device (where a NumPy ``V`` goes;
    default the CUDA card), mesh (``parallel.make_mesh``: every rank
    calls with the same arguments and gets the whole W and H).  W and H
    come back as tensors on the run's device; the cost trace keeps
    length maxiter, zero after an early stop.
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

    W0 = cfg.get("W_init")
    if W0 is None:
        W0 = unit_sum_columns(uniform_init(gen, (m, k), dtype, src))  # lnmf.m:112-113
    H0 = cfg.get("H_init")
    if H0 is None:
        H0 = uniform_init(gen, (k, n), dtype, src)
    W0 = unit_sum_columns(as_tensor(W0, dtype, src))  # lnmf.m:64
    H0 = as_tensor(H0, dtype, src)

    pad_m, pad_n, valid = plan_padding(mesh, m, n)
    if valid is not None:
        V = pad_axes(V, {0: pad_m, 1: pad_n})
        W0 = pad_axes(W0, {0: pad_m})
        H0 = pad_axes(H0, {1: pad_n})
    V, W0, H0 = apply_placements(mesh, "lnmf", V=V, W=W0, H=H0)

    ce = parse_cost_every(cfg)
    with torch.no_grad():
        step = _make_step(V, eps, bool(cfg.get("W_fixed", False)),
                          bool(cfg.get("H_fixed", False)), ce, maxiter, valid, mesh)
        out = looplib.run(step, looplib.cadence_state((W0, H0), ce, dtype),
                          maxiter, tolerance, inclusive=True, cost_dtype=dtype,
                          cost_every=ce)
    W = gather_factor(mesh, out.state[0], "m", 0)[:m]
    H = gather_factor(mesh, out.state[1], "n", 1)[:, :n]
    return Result(fields=("W", "H", "cost"), W=W, H=H,
                  cost=looplib.trim_cost(out, maxiter, trim=False),
                  n_iters=out.n_iters, converged=out.stopped)
