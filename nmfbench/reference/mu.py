"""Plain PyTorch multiplicative updates: the reference that decides `correct`.

Written from the update equations of the upstream toolbox's ``nmf.m``
(github.com/colinvaz/nmf-toolbox, nmf.m:132-224): W's columns are scaled
to unit L2 norm at entry and after every W update, the W update carries
the "diag" terms that the normalization adds to the gradient, and the
stop rule fires at the first iteration i >= 1 with
``cost[i] < cost[i-1]`` and ``cost[i-1] - cost[i] < tolerance``.
Per-entry weights M (missing entries) minimize ``sum(M * d(V, W H))``;
for KL the all-ones field of nmf.m:153,184 becomes M.

Two divergences:

* ``euclidean``: W update with ``V H'`` and ``W (H H')`` (the
  reconstruction's product ``(W H) H'`` by associativity), H update with
  ``W' V`` and ``(W' W) H``; the cost ``0.5 ||V - W H||^2`` is taken from
  the residual itself, in blocks of rows, never from Gram identities.
* ``kl``: the reconstruction ``W H`` is built in full, the field
  ``V / (W H)`` too; the cost ``sum(V log(V / WH) - V + WH)`` reuses the
  reconstruction the next W update needs.

Nothing here imports the measured program: the reference takes V, W0,
H0 (and M) as the benchmark made them and works the trajectory out
again.  Products run in the precision :func:`matmul_precision` sets;
the reference proper runs with TF32 off, and the control of
``nmfbench/control.py`` runs the same code with TF32 on.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

EPS = float(np.finfo(np.float64).eps)  # nmf.m's eps in the update denominators
ROW_BLOCK = 8192  # rows of V per block of the Euclidean residual


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """Products of f32 operands in TF32 (``tf32=True``) or in full f32,
    whatever the caller had set; the caller's setting comes back on exit."""
    mm = torch.backends.cuda.matmul
    if hasattr(mm, "fp32_precision"):
        saved = mm.fp32_precision
        mm.fp32_precision = "tf32" if tf32 else "ieee"
        try:
            yield
        finally:
            mm.fp32_precision = saved
    else:
        saved = mm.allow_tf32
        mm.allow_tf32 = tf32
        try:
            yield
        finally:
            mm.allow_tf32 = saved


def unit_columns(W):
    return W / torch.sqrt(torch.sum(W * W, dim=0, keepdim=True))


def euclidean_cost(V, W, H):
    total = torch.zeros((), dtype=torch.float64, device=V.device)
    for r0 in range(0, V.shape[0], ROW_BLOCK):
        R = V[r0:r0 + ROW_BLOCK] - W[r0:r0 + ROW_BLOCK] @ H
        total += torch.sum(R * R).double()
    return 0.5 * total


def kl_cost(V, V_hat, M=None):
    term = V * torch.log(V / V_hat) - V + V_hat
    if M is not None:
        term = torch.where(M > 0, M * term, torch.zeros((), dtype=V.dtype, device=V.device))
    return torch.sum(term)


def euclidean_step(V, W, H, M=None):
    if M is not None:
        raise ValueError("the Euclidean reference takes no weights")
    VHt = V @ H.T
    WHHt = W @ (H @ H.T)
    dneg = torch.sum(W * WHHt, dim=0)  # diag(H V_hat' W)
    dpos = torch.sum(W * VHt, dim=0)   # diag(H V' W)
    W = W * ((VHt + W * dneg) / torch.clamp_min(WHHt + W * dpos, EPS))
    W = unit_columns(W)
    H = H * ((W.T @ V) / torch.clamp_min((W.T @ W) @ H, EPS))
    return W, H, euclidean_cost(V, W, H), None


def kl_step(V, W, H, M=None, V_hat=None):
    if V_hat is None:
        V_hat = W @ H
    phi = V / V_hat
    if M is not None:
        phi = torch.where(M > 0, M * phi, torch.zeros((), dtype=V.dtype, device=V.device))
    A = phi @ H.T                                    # Phi H'
    B = torch.sum(H, dim=1)[None, :] if M is None else M @ H.T  # ones (or M) times H'
    dneg = torch.sum(W * B, dim=0)                   # diag(H 1' W)
    dpos = torch.sum(W * A, dim=0)                   # diag(H Phi' W)
    W = W * ((A + W * dneg) / torch.clamp_min(B + W * dpos, EPS))
    W = unit_columns(W)
    del phi, A, V_hat
    V_hat = W @ H
    phi = V / V_hat
    if M is not None:
        phi = torch.where(M > 0, M * phi, torch.zeros((), dtype=V.dtype, device=V.device))
        pos = W.T @ M
    else:
        pos = torch.sum(W, dim=0)[:, None]
    H = H * ((W.T @ phi) / torch.clamp_min(pos, EPS))
    del phi
    V_hat = W @ H
    return W, H, kl_cost(V, V_hat, M), V_hat


STEPS = {"euclidean": euclidean_step, "kl": kl_step}


def solve(V, W0, H0, divergence, tolerance, maxiter, *, M=None, snapshots=(),
          tf32=False):
    """Run MU from (W0, H0) with the stop rule, in V's dtype on V's device.

    Runs until the stop rule fires and at least to every iteration count
    in ``snapshots`` (at most ``maxiter``), so that the factors after
    exactly that many iterations can be set beside a program's.  Returns
    ``{"cost": f64 array of every iteration run, "n_iters": where the
    rule fired (None if it never did), "W", "H": the factors at the
    stop, "snap": {count: (W, H)}}``.
    """
    step = STEPS[divergence]
    want = {int(s) for s in snapshots if 0 < int(s) <= maxiter}
    last = max(want, default=0)
    tol = torch.tensor(tolerance, dtype=V.dtype, device=V.device)
    costs, snap, n_stop, stop_at = [], {}, None, None
    with torch.no_grad(), matmul_precision(tf32):
        W, H = unit_columns(W0.to(V.dtype)), H0.to(V.dtype)
        extra = None
        prev = None
        for i in range(maxiter):
            if divergence == "kl":
                W, H, c, extra = kl_step(V, W, H, M, extra)
            else:
                W, H, c, _ = step(V, W, H, M)
            c = c.to(V.dtype)
            costs.append(c)
            if (n_stop is None and prev is not None
                    and bool((c < prev) & (prev - c < tol))):
                n_stop = i + 1
                stop_at = (W, H)
            prev = c
            if i + 1 in want:
                snap[i + 1] = (W.clone(), H.clone())
            if n_stop is not None and i + 1 >= last:
                break
    if stop_at is None:
        stop_at = (W, H)
    cost = torch.stack(costs).double().cpu().numpy()
    return {"cost": cost, "n_iters": n_stop, "W": stop_at[0], "H": stop_at[1],
            "snap": snap}
