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

Under a mesh (``parallel.placements_for("constrainednmf")``) V, in the
unlabeled-first order and zero-padded, shards like nmf's, W follows its
rows and Z is replicated.  Each rank's H is Z A on its own global
columns; the Z fields X A' of its (k, b) block scatter into Z's layout
(unlabeled columns at their global index, labeled columns summed into
their class) and sum over samples, so every rank holds the same Z.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import (Result, as_tensor, common_scalars, merge_config,
                    parse_cost_every, resolve_device, resolve_dtype,
                    staging_device, uniform_init)
from ..ops import divergence as dv
from ..ops import loop as looplib
from ..ops.masking import region_mask
from ..ops.normalize import unit_l2_columns
from ..parallel.collectives import gather_factor, sum_features, sum_samples
from ..parallel.mesh import apply_placements, block_offset, check_mesh
from ..parallel.padding import pad_axes, plan_padding, prepare_weights


def label_maps(class_onehot, n_u, c0, b):
    """``(apply_A, apply_At)`` for the columns c0 .. c0+b of the
    (padded) sample axis, unlabeled first: H = Z A on those columns, and
    X A' of a (k, b) block X of those columns in Z's layout (its share of
    the sum over every column block).  ``class_onehot`` is the (C, n -
    n_u) class indicator of the labeled columns, zero on pad columns."""
    u1 = min(max(n_u - c0, 0), b)                  # this block's unlabeled columns
    onehot = class_onehot[:, max(c0 - n_u, 0):max(c0 + b - n_u, 0)]  # its labeled ones

    def apply_A(Z):
        """H = Z A: the unlabeled block passes through; a labeled sample
        takes its class's column of Z."""
        return torch.cat([Z[:, c0:c0 + u1], Z[:, n_u:] @ onehot], dim=1)

    def apply_At(X):
        """X A': the unlabeled columns, then per-class sums of the labeled."""
        out = torch.zeros((X.shape[0], n_u + onehot.shape[0]), dtype=X.dtype,
                          device=X.device)
        out[:, c0:c0 + u1] = X[:, :u1]
        out[:, n_u:] = X[:, u1:] @ onehot.T
        return out

    return apply_A, apply_At


def _make_step(V, class_onehot, n_u, div, alpha, beta, wsp, zsp, eps,
               w_fixed, z_fixed, ce, maxiter, Mw=None, valid=None, mesh=None):
    b = V.shape[1]
    c0 = block_offset(mesh, b)
    mask = region_mask(V.shape, valid, V.device, (block_offset(mesh, V.shape[0], "m"), c0))
    cadence = looplib.cost_cadence(ce, maxiter)
    apply_A, apply_At = label_maps(class_onehot, n_u, c0, b)

    def step(carry, i):
        W, Z = carry[0], carry[1]
        H = apply_A(Z)
        V_hat = W @ H
        if not w_fixed:
            phi_neg, phi_pos, power = dv.fields(div, V, V_hat, alpha, beta,
                                                mask=mask, weights=Mw)
            if phi_pos is None:
                A_, h_rowsum = sum_samples(mesh, phi_neg @ H.T, torch.sum(H, dim=1))
                B_ = h_rowsum[None, :].expand(A_.shape)
            else:
                A_, B_ = sum_samples(mesh, phi_neg @ H.T, phi_pos @ H.T)
            dneg, dpos = sum_features(mesh, torch.sum(W * B_, dim=0),
                                      torch.sum(W * A_, dim=0))
            neg = dv.apply_power(A_ + W * dneg[None, :], power)
            pos = dv.apply_power(B_ + W * dpos[None, :], power)
            W = W * (neg / torch.clamp_min(pos + wsp, eps))
            W = unit_l2_columns(W, mesh)
            V_hat = W @ H
        if not z_fixed:
            phi_neg, phi_pos, power = dv.fields(div, V, V_hat, alpha, beta,
                                                mask=mask, weights=Mw)
            if phi_pos is None:
                neg, w_colsum = sum_features(mesh, W.T @ phi_neg, torch.sum(W, dim=0))
                pos = apply_At(w_colsum[:, None].expand(W.shape[1], b))
            else:
                neg, pos = sum_features(mesh, W.T @ phi_neg, W.T @ phi_pos)
                pos = apply_At(pos)
            neg, pos = sum_samples(mesh, apply_At(neg), pos)
            neg = dv.apply_power(neg, power)
            pos = dv.apply_power(pos, power)
            Z = Z * (neg / torch.clamp_min(pos + zsp, eps))
            V_hat = W @ apply_A(Z)

        def cost_fn(W=W, Z=Z, V_hat=V_hat):
            # The objective's divergence pass exists only for the stop
            # rule; cost_every > 1 skips it.
            c = dv.cost(div, V, V_hat, alpha, beta, mask=mask, weights=Mw, mesh=mesh)
            w1 = torch.sum(torch.abs(W))
            if mesh is not None and wsp:
                w1 = sum_features(mesh, w1)
            return c + wsp * w1 + zsp * torch.sum(torch.abs(Z))

        return cadence((W, Z), carry, i, cost_fn)

    return step


def constrainednmf(V, labels, num_basis_elems: int,
                   config: dict | None = None, **kwargs):
    """Constrained NMF.  Returns a :class:`Result` as (W, H, Z, A, cost).

    Parameters (constrainednmf.m:100-142): divergence/alpha/beta (as
    nmf), W_init, Z_init, W_sparsity, Z_sparsity, W_fixed, Z_fixed,
    maxiter (100), tolerance (1e-3).  ``labels`` has length n; -1 marks
    an unlabeled sample.  Extras: weights ((m, n) non-negative per-entry
    weights), cost_every (objective cadence), dtype, seed, eps, device
    (where a NumPy ``V`` goes; default the CUDA card), mesh
    (``parallel.make_mesh``: every rank calls with the same arguments and
    gets the whole factors).  W, H and Z come back as tensors on the
    run's device and A as a NumPy array; H and A are in the ORIGINAL
    sample order (constrainednmf.m:260-267).
    """
    cfg = merge_config(config, kwargs)
    mesh = check_mesh(cfg.get("mesh"))
    device = resolve_device(V, cfg.get("device"), mesh)
    dtype = resolve_dtype(V, cfg.get("dtype"))
    src = staging_device(V, device, mesh)  # the whole arrays until placement
    V = as_tensor(V, dtype, src)
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
    perm = torch.as_tensor(sorted_idx, device=src)
    V_sorted = V[:, perm]
    pad_m, pad_n, valid = plan_padding(mesh, m, n)
    # the labeled block of A gains zero columns so H = Z A spans the padded n
    class_onehot = torch.zeros((num_classes, num_labeled + pad_n), dtype=dtype,
                               device=device)
    class_onehot[torch.as_tensor(sorted_labels[n_u:] - 1, device=device),
                 torch.arange(num_labeled, device=device)] = 1.0

    W0 = cfg.get("W_init")
    if W0 is None:
        W0 = uniform_init(gen, (m, k), dtype, src, floor_eps=False)  # constrainednmf.m:101
    W0 = unit_l2_columns(as_tensor(W0, dtype, src))  # constrainednmf.m:144-145
    Z0 = cfg.get("Z_init")
    if Z0 is None:
        Z0 = uniform_init(gen, (k, n_u + num_classes), dtype, src, floor_eps=False)  # :174
    Z0 = as_tensor(Z0, dtype, src)

    weights = cfg.get("weights")
    if weights is not None:
        # per-entry weights follow V through the unlabeled-first reorder
        weights = as_tensor(weights, dtype, staging_device(weights, device, mesh))
        if tuple(weights.shape) == (m, n):
            weights = weights[:, perm.to(weights.device)]
    if valid is not None:
        V_sorted = pad_axes(V_sorted, {0: pad_m, 1: pad_n})
        W0 = pad_axes(W0, {0: pad_m})
    V_sorted, W0, Z0 = apply_placements(mesh, "constrainednmf", V=V_sorted, W=W0, Z=Z0)
    weights = prepare_weights(weights, dtype, (m, n), mesh, "constrainednmf",
                              pad_m, pad_n, valid, device=device)

    ce = parse_cost_every(cfg)
    with torch.no_grad():
        step = _make_step(
            V_sorted, class_onehot, n_u, div, alpha, beta, wsp, zsp, eps,
            bool(cfg.get("W_fixed", False)), bool(cfg.get("Z_fixed", False)),
            ce, maxiter, weights, valid, mesh)
        out = looplib.run(step, looplib.cadence_state((W0, Z0), ce, dtype),
                          maxiter, tolerance, cost_dtype=dtype, cost_every=ce)
        W, Z = gather_factor(mesh, out.state[0], "m", 0)[:m], out.state[1]
        # H = Z A on the device: A has one 1 per column, so each entry of
        # H is one term of Z, and back in the original sample order.
        H = torch.empty((k, n), dtype=dtype, device=device)
        H[:, perm.to(device)] = label_maps(class_onehot[:, :num_labeled], n_u, 0, n)[0](Z)

    # A in the original sample order (constrainednmf.m:263-267).
    A_sorted = np.zeros((n_u + num_classes, n))
    A_sorted[:n_u, :n_u] = np.eye(n_u)
    A_sorted[n_u:, n_u:] = class_onehot[:, :num_labeled].cpu().numpy()
    A = np.zeros_like(A_sorted)
    A[:, sorted_idx] = A_sorted
    return Result(fields=("W", "H", "Z", "A", "cost"), W=W, H=H, Z=Z, A=A,
                  cost=looplib.trim_cost(out, maxiter),
                  n_iters=out.n_iters, converged=out.stopped)
