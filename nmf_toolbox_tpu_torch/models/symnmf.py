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

Under a mesh (``parallel.placements_for("symnmf")``) n is zero-padded to
a multiple of both mesh axes, A's rows and H's rows shard together over
the feature axis and A's columns over the sample axis.  A H needs the
rows of H that meet this rank's columns of A: H is gathered over the
feature axis (k n values), multiplied locally and summed over samples;
H'H sums over features.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import (Result, as_tensor, common_scalars, merge_config,
                    resolve_device, resolve_dtype, staging_device, uniform_init)
from ..ops import loop as looplib
from ..parallel.collectives import gather_factor, sum_all, sum_features, sum_samples
from ..parallel.mesh import apply_placements, check_mesh
from ..parallel.padding import mesh_multiples, pad_amount, pad_axes


def _products(A, H, mesh):
    """(A H, H'H) for this rank's rows of H: A's column block meets the
    rows of the whole H it covers, and the block products sum over
    samples."""
    if mesh is None:
        return A @ H, H.T @ H
    b = A.shape[1]
    c0 = mesh.coord("n") * b
    Hc = gather_factor(mesh, H, "m", 0)[c0:c0 + b]
    AH = sum_samples(mesh, A @ Hc)
    return AH, sum_features(mesh, H.T @ H)


def _make_step(A, eps, mesh=None):
    a_sq = sum_all(mesh, torch.sum(A * A))

    def step(carry, i):
        H, AH, G = carry
        H = H * (0.5 + 0.5 * (AH / torch.clamp_min(H @ G, eps)))
        AH, G = _products(A, H, mesh)
        # clamped as ops/gram.euclidean_cost_gram is
        c = torch.clamp_min(0.5 * (a_sq - 2.0 * sum_features(mesh, torch.sum(AH * H))
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
    relative; pass (A + A.T)/2 to symmetrize), mesh
    (``parallel.make_mesh``: every rank calls with the same arguments and
    gets the whole H).  H comes back as a tensor on the run's device;
    cluster assignments are ``torch.argmax(res.H, dim=1)``.
    """
    cfg = merge_config(config, kwargs)
    mesh = check_mesh(cfg.get("mesh"))
    device = resolve_device(A, cfg.get("device"), mesh)
    dtype = resolve_dtype(A, cfg.get("dtype"))
    src = staging_device(A, device, mesh)  # the whole arrays until placement
    A = as_tensor(A, dtype, src)
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
        H0 = uniform_init(gen, (n, k), dtype, src) * (2.0 * scale)
    H0 = as_tensor(H0, dtype, src)
    if tuple(H0.shape) != (n, k):
        raise ValueError(f"H_init has shape {tuple(H0.shape)}, expected {(n, k)}")

    # A stays square (A H contracts its columns against H's rows), so
    # both axes pad by the least amount that every mesh axis divides; the
    # zero rows of H stay zero and add nothing to A H, the Grams or the cost.
    pad = pad_amount(n, math.lcm(*mesh_multiples(mesh)))
    if pad:
        A = pad_axes(A, {0: pad, 1: pad})
        H0 = pad_axes(H0, {0: pad})
    A, H0 = apply_placements(mesh, "symnmf", A=A, H=H0)

    with torch.no_grad():
        out = looplib.run(_make_step(A, eps, mesh), (H0,) + _products(A, H0, mesh),
                          maxiter, tolerance, cost_dtype=dtype)
    return Result(fields=("H", "cost"), H=gather_factor(mesh, out.state[0], "m", 0)[:n],
                  cost=looplib.trim_cost(out, maxiter),
                  n_iters=out.n_iters, converged=out.stopped)
