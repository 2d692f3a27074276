"""Symmetric NMF: A ~ H H' (Ding, He & Simon 2005).

PyTorch counterpart of ``nmf_toolbox_tpu/models/symnmf.py``.  A is a
symmetric non-negative similarity (a kernel, a graph adjacency, or the
consensus matrix of ``consensus_stability``) and H (n, k) >= 0 a soft
cluster indicator whose row-wise argmax is the hard assignment.  The
update is the alpha = 1/2 damped rule (Ding et al. 2005 eq. 11):

    H <- H * (1/2 + 1/2 * (A H) / (H (H' H)))

One (n, n) x (n, k) product per iteration: A H and H'H of the updated H
are both the cost's inputs and the next update's, so they ride the
loop's state.  The cost uses the Gram identity ||A - H H'||^2 = ||A||^2
- 2 <A H, H> + ||H'H||^2, whose f32 cancellation floor is ~||A||^2
eps_f32 (run f64 for a strictly monotone trace).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import (Result, as_tensor, common_scalars, merge_config,
                    reject_mesh, resolve_device, resolve_dtype, uniform_init)
from ..ops import loop as looplib


def _make_step(A, eps):
    a_sq = torch.sum(A * A)

    def step(carry, i):
        H, AH, G = carry
        H = H * (0.5 + 0.5 * (AH / torch.clamp_min(H @ G, eps)))
        AH, G = A @ H, H.T @ H
        # clamped as ops/gram.euclidean_cost_gram is
        c = torch.clamp_min(0.5 * (a_sq - 2.0 * torch.sum(AH * H)
                                   + torch.sum(G * G)), 0.0)
        return (H, AH, G), c, False

    return step


def symnmf(A, num_basis_elems: int, config: dict | None = None, **kwargs):
    """Symmetric NMF A ~ H H'.  Returns a :class:`Result` with H (n, k)
    and cost.

    Parameters: H_init (n, k; default scaled uniform, sqrt(mean(A)/k) so
    that H H' starts at A's magnitude), maxiter (100), tolerance (1e-3),
    seed, dtype, eps, device (where a NumPy ``A`` goes; default the CUDA
    card).  A must be square, non-negative and symmetric (to 1e-5
    relative; pass (A + A.T)/2 to symmetrize).  ``mesh`` raises
    ``NotImplementedError``.  H comes back as a tensor on the run's
    device; cluster assignments are ``torch.argmax(res.H, dim=1)``.
    """
    cfg = merge_config(config, kwargs)
    reject_mesh(cfg)
    device = resolve_device(A, cfg.get("device"))
    dtype = resolve_dtype(A, cfg.get("dtype"))
    A = as_tensor(A, dtype, device)
    if A.ndim != 2 or A.shape[0] != A.shape[1]:
        raise ValueError(f"symnmf expects a square similarity matrix; "
                         f"got {tuple(A.shape)}")
    n = A.shape[0]
    a_min, a_absmax, asym = (float(x) for x in torch.stack(
        (torch.min(A), torch.max(torch.abs(A)), torch.max(torch.abs(A - A.T)))))
    if a_min < 0:
        raise ValueError("symnmf expects a nonnegative similarity matrix")
    if asym > 1e-5 * max(a_absmax, 1e-30):
        raise ValueError(
            f"A is not symmetric (max |A - A'| = {asym:g}); symmetrize "
            "with (A + A.T) / 2 first")
    k = int(num_basis_elems)
    maxiter, tolerance, eps, gen = common_scalars(cfg)

    H0 = cfg.get("H_init")
    if H0 is None:
        # A poorly scaled init stalls the damped update.
        scale = np.sqrt(max(float(torch.mean(A)), 1e-30) / k)
        H0 = uniform_init(gen, (n, k), dtype, device) * (2.0 * scale)
    H0 = as_tensor(H0, dtype, device)
    if tuple(H0.shape) != (n, k):
        raise ValueError(f"H_init has shape {tuple(H0.shape)}, expected {(n, k)}")

    with torch.no_grad():
        out = looplib.run(_make_step(A, eps), (H0, A @ H0, H0.T @ H0),
                          maxiter, tolerance, cost_dtype=dtype)
    return Result(fields=("H", "cost"), H=out.state[0],
                  cost=looplib.trim_cost(out, maxiter),
                  n_iters=out.n_iters, converged=out.stopped)
