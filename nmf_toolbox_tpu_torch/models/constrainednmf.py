"""Semi-supervised NMF with hard label constraints (Liu & Wu 2010).

PyTorch counterpart of ``nmf_toolbox_tpu/models/constrainednmf.py``
(reference: constrainednmf.m): V ~ W Z A, where A is the fixed label
block matrix [I 0; 0 C] (unlabeled samples first, constrainednmf.m:
160-172) and H = Z A.  The W update is nmf's four-divergence family
(``ops/divergence``); the Z update projects the fields through A'
(constrainednmf.m:214-235).  A is a 0/1 selection, so Z A and X A' are
a slice plus a product with the (C, n_labeled) class one-hot, never a
dense (n_u + C, n) product.

Compat note (COMPAT.md): the reference's AB-divergence Z update
(constrainednmf.m:229) is shape-inconsistent as written; the paper's
grouping W'(V.^a .* V_hat.^(b-1))A' is used.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import (Result, as_tensor, common_scalars, merge_config,
                    parse_cost_every, reject_mesh,
                    resolve_device, resolve_dtype, uniform_init)
from ..ops import divergence as dv
from ..ops import loop as looplib
from ..ops.normalize import unit_l2_columns
from ..parallel.padding import prepare_weights


def _make_step(V, class_onehot, n_u, div, alpha, beta, wsp, zsp, eps,
               w_fixed, z_fixed, ce, maxiter, Mw=None):
    n = V.shape[1]
    cadence = looplib.cost_cadence(ce, maxiter)

    def apply_A(Z):
        """H = Z A: the unlabeled block passes through; a labeled sample
        takes its class's column of Z."""
        return torch.cat([Z[:, :n_u], Z[:, n_u:] @ class_onehot], dim=1)

    def apply_At(X):
        """X A': the unlabeled columns, then per-class sums of the labeled."""
        return torch.cat([X[:, :n_u], X[:, n_u:] @ class_onehot.T], dim=1)

    def step(carry, i):
        W, Z = carry[0], carry[1]
        H = apply_A(Z)
        V_hat = W @ H
        if not w_fixed:
            phi_neg, phi_pos, power = dv.fields(div, V, V_hat, alpha, beta, weights=Mw)
            A_ = phi_neg @ H.T
            if phi_pos is None:
                B_ = torch.sum(H, dim=1)[None, :].expand(A_.shape)
            else:
                B_ = phi_pos @ H.T
            dneg = torch.sum(W * B_, dim=0)
            dpos = torch.sum(W * A_, dim=0)
            neg = dv.apply_power(A_ + W * dneg[None, :], power)
            pos = dv.apply_power(B_ + W * dpos[None, :], power)
            W = W * (neg / torch.clamp_min(pos + wsp, eps))
            W = unit_l2_columns(W)
            V_hat = W @ H
        if not z_fixed:
            phi_neg, phi_pos, power = dv.fields(div, V, V_hat, alpha, beta, weights=Mw)
            neg = apply_At(W.T @ phi_neg)
            if phi_pos is None:
                pos = apply_At(torch.sum(W, dim=0)[:, None].expand(W.shape[1], n))
            else:
                pos = apply_At(W.T @ phi_pos)
            neg = dv.apply_power(neg, power)
            pos = dv.apply_power(pos, power)
            Z = Z * (neg / torch.clamp_min(pos + zsp, eps))
            V_hat = W @ apply_A(Z)

        def cost_fn(W=W, Z=Z, V_hat=V_hat):
            # The objective's divergence pass exists only for the stop
            # rule; cost_every > 1 skips it.
            c = dv.cost(div, V, V_hat, alpha, beta, weights=Mw)
            return c + wsp * torch.sum(torch.abs(W)) + zsp * torch.sum(torch.abs(Z))

        return cadence((W, Z), carry, i, cost_fn)

    return step, apply_A


def constrainednmf(V, labels, num_basis_elems: int,
                   config: dict | None = None, **kwargs):
    """Constrained NMF.  Returns a :class:`Result` as (W, H, Z, A, cost).

    Parameters (constrainednmf.m:100-142): divergence/alpha/beta (as
    nmf), W_init, Z_init, W_sparsity, Z_sparsity, W_fixed, Z_fixed,
    maxiter (100), tolerance (1e-3).  ``labels`` has length n; -1 marks
    an unlabeled sample.  Extras: weights ((m, n) non-negative per-entry
    weights), cost_every (objective cadence), dtype, seed, eps, device
    (where a NumPy ``V`` goes; default the CUDA card).  ``mesh`` raises
    ``NotImplementedError``.  W, H and Z come back as tensors on the
    run's device and A as a NumPy array; H and A are in the ORIGINAL
    sample order (constrainednmf.m:260-267).
    """
    cfg = merge_config(config, kwargs)
    reject_mesh(cfg)
    device = resolve_device(V, cfg.get("device"))
    dtype = resolve_dtype(V, cfg.get("dtype"))
    V = as_tensor(V, dtype, device)
    m, n = V.shape
    k = int(num_basis_elems)
    labels = np.asarray(labels)
    if len(labels) != n:
        raise ValueError(
            f"Length of the label vector not equal to number of samples. "
            f"Length of label vector = {len(labels)}; number of samples = {n}")

    div = dv.canon(cfg.get("divergence", "euclidean"))
    if div == "ab":
        alpha = float(cfg.get("alpha", 1.0))
        beta = float(cfg.get("beta", 1.0))
        if alpha == 0.0 and beta == 0.0:
            raise ValueError("alpha = 0 and beta = 0 is not supported at this time.")
    else:
        alpha, beta = 1.0, 1.0

    maxiter, tolerance, eps, gen = common_scalars(cfg)
    wsp = max(float(cfg.get("W_sparsity", 0.0) or 0.0), 0.0)
    zsp = max(float(cfg.get("Z_sparsity", 0.0) or 0.0), 0.0)

    # Label preprocessing (constrainednmf.m:147-172): classes numbered
    # from 1, unlabeled samples first.
    num_labeled = int(np.sum(labels > -1))
    uniq = np.unique(labels)
    if num_labeled < n:
        num_classes = len(uniq) - 1
        lp = np.searchsorted(uniq, labels)
        lp = np.where(lp == 0, -1, lp)
    else:
        num_classes = len(uniq)
        lp = np.searchsorted(uniq, labels) + 1
    sorted_idx = np.argsort(lp, kind="stable")
    sorted_labels = lp[sorted_idx]
    n_u = n - num_labeled
    perm = torch.as_tensor(sorted_idx, device=device)
    V_sorted = V[:, perm]
    class_onehot = torch.zeros((num_classes, num_labeled), dtype=dtype, device=device)
    class_onehot[torch.as_tensor(sorted_labels[n_u:] - 1, device=device),
                 torch.arange(num_labeled, device=device)] = 1.0

    W0 = cfg.get("W_init")
    if W0 is None:
        W0 = uniform_init(gen, (m, k), dtype, device, floor_eps=False)  # constrainednmf.m:101
    W0 = unit_l2_columns(as_tensor(W0, dtype, device))  # constrainednmf.m:144-145
    Z0 = cfg.get("Z_init")
    if Z0 is None:
        Z0 = uniform_init(gen, (k, n_u + num_classes), dtype, device, floor_eps=False)  # :174
    Z0 = as_tensor(Z0, dtype, device)

    weights = cfg.get("weights")
    if weights is not None:
        # per-entry weights follow V through the unlabeled-first reorder
        weights = prepare_weights(weights, dtype, (m, n), None, "constrainednmf",
                                  0, 0, None, device=device)[:, perm]

    ce = parse_cost_every(cfg)
    with torch.no_grad():
        step, apply_A = _make_step(
            V_sorted, class_onehot, n_u, div, alpha, beta, wsp, zsp, eps,
            bool(cfg.get("W_fixed", False)), bool(cfg.get("Z_fixed", False)),
            ce, maxiter, weights)
        out = looplib.run(step, looplib.cadence_state((W0, Z0), ce, dtype),
                          maxiter, tolerance, cost_dtype=dtype, cost_every=ce)
        W, Z = out.state[0], out.state[1]
        # H = Z A on the device: A has one 1 per column, so each entry of
        # H is one term of Z, and back in the original sample order.
        H = torch.empty((k, n), dtype=dtype, device=device)
        H[:, perm] = apply_A(Z)

    # A in the original sample order (constrainednmf.m:263-267).
    A_sorted = np.zeros((n_u + num_classes, n))
    A_sorted[:n_u, :n_u] = np.eye(n_u)
    A_sorted[n_u:, n_u:] = class_onehot.cpu().numpy()
    A = np.zeros_like(A_sorted)
    A[:, sorted_idx] = A_sorted
    return Result(fields=("W", "H", "Z", "A", "cost"), W=W, H=H, Z=Z, A=A,
                  cost=looplib.trim_cost(out, maxiter),
                  n_iters=out.n_iters, converged=out.stopped)
