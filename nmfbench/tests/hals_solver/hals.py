"""Plain PyTorch HALS (Cichocki & Phan 2009), for the tests only: the
reference of ``nmf_hals.py`` beside it, copied into a throwaway root.

Each iteration solves every rank-1 subproblem exactly, in order:
``w_j <- max(w_j + ((V H')_j - W (H H')_j) / (H H')_jj, eps)`` for each
column of W, ``inner`` times against the same ``H H'`` and ``V H'``,
then H's rows likewise against ``W' W`` and ``W' V``.  The cost
``0.5 ||V - W H||^2`` is taken from the residual itself.  The stop rule
is inclusive: it fires at the first iteration i >= 1 with
``cost[i] <= cost[i-1]`` and ``cost[i-1] - cost[i] <= tolerance``.
Imports nothing of the benchmark or of the program.
"""
from __future__ import annotations

import numpy as np
import torch

EPS = float(np.finfo(np.float64).eps)


def _sweep_columns(X, G, D, eps):
    """Columns of X (p x k) in order, against G (k x k) and D (p x k)."""
    for j in range(X.shape[1]):
        step = (D[:, j] - X @ G[:, j]) / torch.clamp_min(G[j, j], eps)
        X[:, j] = torch.clamp_min(X[:, j] + step, eps)


def solve(V, W0, H0, tolerance, maxiter, *, inner=1, snapshots=(), tf32=False):
    """As ``nmfbench/reference/mu.py: solve`` returns it."""
    if tf32:
        raise ValueError("this reference runs on the CPU only")
    want = {int(s) for s in snapshots if 0 < int(s) <= maxiter}
    last = max(want, default=0)
    costs, snap, n_stop, stop_at, prev = [], {}, None, None, None
    with torch.no_grad():
        W, H = W0.to(V.dtype).clone(), H0.to(V.dtype).clone()
        Ht = H.T.clone()
        for i in range(maxiter):
            HHt, VHt = Ht.T @ Ht, V @ Ht
            for _ in range(inner):
                _sweep_columns(W, HHt, VHt, EPS)
            WtW, VtW = W.T @ W, V.T @ W
            for _ in range(inner):
                _sweep_columns(Ht, WtW, VtW, EPS)
            c = 0.5 * torch.sum((V - W @ Ht.T) ** 2)
            costs.append(c)
            if n_stop is None and prev is not None and bool((c <= prev) & (prev - c <= tolerance)):
                n_stop = i + 1
                stop_at = (W.clone(), Ht.T.clone())
            prev = c
            if i + 1 in want:
                snap[i + 1] = (W.clone(), Ht.T.clone())
            if n_stop is not None and i + 1 >= last:
                break
    if stop_at is None:
        stop_at = (W, Ht.T.clone())
    cost = torch.stack(costs).double().cpu().numpy()
    return {"cost": cost, "n_iters": n_stop, "W": stop_at[0], "H": stop_at[1], "snap": snap}
