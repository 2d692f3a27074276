"""Semi-NMF (Ding, Li & Jordan 2010): W unconstrained, H >= 0.

PyTorch counterpart of ``nmf_toolbox_tpu/models/seminmf.py`` (reference:
seminmf.m).  The exact W solve V H' / (H H') (seminmf.m:68) is an LU
solve of the k-by-k Gram on the device; the sqrt multiplicative H update
uses pos/neg Gram splits (seminmf.m:73-77, without an eps guard, as in
the reference); the Euclidean cost comes from the Grams, so no m-by-n
reconstruction is formed.

Under a mesh (``parallel.placements_for("seminmf")``) H H' and V H' sum
over samples before the k-by-k solve, which every rank then takes on
the same Gram; W'V and W'W sum over features; the k-means init runs on
the whole V before placement.  The pad columns of a padded problem have
a 0/0 sqrt ratio, pinned to zero as in the JAX package.
"""
from __future__ import annotations

import torch

from ..core import (Result, as_tensor, common_scalars, merge_config,
                    resolve_device, resolve_dtype, staging_device, uniform_init)
from ..ops import loop as looplib
from ..ops.gram import euclidean_cost_gram, pos_neg_split, sq_norm
from ..ops.masking import col_mask
from ..parallel.collectives import gather_factor, sum_all, sum_features, sum_samples
from ..parallel.mesh import apply_placements, block_offset, check_mesh
from ..parallel.padding import pad_axes, plan_padding
from ..utils.init import kmeans_indicator_h


def _make_step(V, v_sq, w_fixed, h_fixed, n_valid=None, mesh=None):
    cmask = col_mask(V.shape[1], n_valid, V.device, block_offset(mesh, V.shape[1]))

    def step(carry, i):
        W, H = carry
        if not w_fixed:
            # W = V H' (H H')^-1 (seminmf.m:68).  LU, not Cholesky: like
            # MATLAB's mrdivide it gives finite values for a Gram that is
            # semi-definite to roundoff, where a Cholesky solve gives NaN.
            # solve_ex does not check the factorization, so it never waits
            # on the device.
            HHt, VHt = sum_samples(mesh, H @ H.T, V @ H.T)
            W = torch.linalg.solve_ex(HHt, VHt.T).result.T
        WtV, WtW = sum_features(mesh, W.T @ V, W.T @ W)
        if not h_fixed:
            wv_pos, wv_neg = pos_neg_split(WtV)
            ww_pos, ww_neg = pos_neg_split(WtW)
            # seminmf.m:73-77 (no eps guard in the reference)
            ratio = (wv_pos + ww_neg @ H) / (wv_neg + ww_pos @ H)
            if cmask is not None:
                ratio = torch.where(cmask[None, :], ratio,
                                    torch.zeros((), dtype=ratio.dtype, device=ratio.device))
            H = H * torch.sqrt(ratio)
        return (W, H), euclidean_cost_gram(v_sq, WtV, WtW, H, mesh=mesh), False

    return step


def seminmf(V, num_basis_elems: int, config: dict | None = None, **kwargs):
    """Semi-NMF; V may be mixed-sign.  Returns a :class:`Result` as
    (W, H, cost).

    Parameters (seminmf.m:99-144): W_init (default uniform in [-1, 1]),
    H_init (default k-means indicator + 0.2), W_fixed, H_fixed, maxiter
    (100), tolerance (1e-3).  Extras: dtype, seed, device (where a NumPy
    ``V`` goes; default the CUDA card), mesh (``parallel.make_mesh``:
    every rank calls with the same arguments and gets the whole W and
    H).  W and H come back as tensors on the run's device.
    """
    cfg = merge_config(config, kwargs)
    mesh = check_mesh(cfg.get("mesh"))
    device = resolve_device(V, cfg.get("device"), mesh)
    dtype = resolve_dtype(V, cfg.get("dtype"))
    src = staging_device(V, device, mesh)  # the whole arrays until placement
    V = as_tensor(V, dtype, src)
    m, n = V.shape
    k = int(num_basis_elems)
    maxiter, tolerance, _, gen = common_scalars(cfg)

    H0 = cfg.get("H_init")
    if H0 is None:
        # The k-means reads the whole V on the run's device, so under a
        # mesh too the whole arrays stay there and placement cuts them.
        src = device
        V = V.to(src)
        H0 = kmeans_indicator_h(gen, V, k, dtype)  # seminmf.m:109-117
    W0 = cfg.get("W_init")
    if W0 is None:
        W0 = 2.0 * uniform_init(gen, (m, k), dtype, src, floor_eps=False) - 1.0  # seminmf.m:121
    W0 = as_tensor(W0, dtype, src)
    H0 = as_tensor(H0, dtype, src)

    pad_m, pad_n, valid = plan_padding(mesh, m, n)
    if valid is not None:
        V = pad_axes(V, {0: pad_m, 1: pad_n})
        W0 = pad_axes(W0, {0: pad_m})
        H0 = pad_axes(H0, {1: pad_n})
    V, W0, H0 = apply_placements(mesh, "seminmf", V=V, W=W0, H=H0)

    with torch.no_grad():
        step = _make_step(V, sum_all(mesh, sq_norm(V)), bool(cfg.get("W_fixed", False)),
                          bool(cfg.get("H_fixed", False)),
                          None if valid is None else n, mesh)
        out = looplib.run(step, (W0, H0), maxiter, tolerance, cost_dtype=dtype)
    W = gather_factor(mesh, out.state[0], "m", 0)[:m]
    H = gather_factor(mesh, out.state[1], "n", 1)[:, :n]
    return Result(fields=("W", "H", "cost"), W=W, H=H,
                  cost=looplib.trim_cost(out, maxiter),
                  n_iters=out.n_iters, converged=out.stopped)
