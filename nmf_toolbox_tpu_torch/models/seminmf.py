"""Semi-NMF (Ding, Li & Jordan 2010): W unconstrained, H >= 0.

PyTorch counterpart of ``nmf_toolbox_tpu/models/seminmf.py`` (reference:
seminmf.m).  The exact W solve V H' / (H H') (seminmf.m:68) is an LU
solve of the k-by-k Gram on the device; the sqrt multiplicative H update
uses pos/neg Gram splits (seminmf.m:73-77, without an eps guard, as in
the reference); the Euclidean cost comes from the Grams, so no m-by-n
reconstruction is formed.
"""
from __future__ import annotations

import torch

from ..core import (Result, as_tensor, common_scalars, merge_config,
                    reject_mesh, resolve_device, resolve_dtype, uniform_init)
from ..ops import loop as looplib
from ..ops.gram import euclidean_cost_gram, pos_neg_split, sq_norm
from ..utils.init import kmeans_indicator_h


def _make_step(V, v_sq, w_fixed, h_fixed):
    def step(carry, i):
        W, H = carry
        if not w_fixed:
            # W = V H' (H H')^-1 (seminmf.m:68).  LU, not Cholesky: like
            # MATLAB's mrdivide it gives finite values for a Gram that is
            # semi-definite to roundoff, where a Cholesky solve gives NaN.
            # solve_ex does not check the factorization, so it never waits
            # on the device.
            HHt = H @ H.T
            VHt = V @ H.T
            W = torch.linalg.solve_ex(HHt, VHt.T).result.T
        WtV = W.T @ V
        WtW = W.T @ W
        if not h_fixed:
            wv_pos, wv_neg = pos_neg_split(WtV)
            ww_pos, ww_neg = pos_neg_split(WtW)
            # seminmf.m:73-77 (no eps guard in the reference)
            H = H * torch.sqrt((wv_pos + ww_neg @ H) / (wv_neg + ww_pos @ H))
        return (W, H), euclidean_cost_gram(v_sq, WtV, WtW, H), False

    return step


def seminmf(V, num_basis_elems: int, config: dict | None = None, **kwargs):
    """Semi-NMF; V may be mixed-sign.  Returns a :class:`Result` as
    (W, H, cost).

    Parameters (seminmf.m:99-144): W_init (default uniform in [-1, 1]),
    H_init (default k-means indicator + 0.2), W_fixed, H_fixed, maxiter
    (100), tolerance (1e-3).  Extras: dtype, seed, device (where a NumPy
    ``V`` goes; default the CUDA card).  ``mesh`` raises
    ``NotImplementedError``.  W and H come back as tensors on the run's
    device.
    """
    cfg = merge_config(config, kwargs)
    reject_mesh(cfg)
    device = resolve_device(V, cfg.get("device"))
    dtype = resolve_dtype(V, cfg.get("dtype"))
    V = as_tensor(V, dtype, device)
    m, n = V.shape
    k = int(num_basis_elems)
    maxiter, tolerance, _, gen = common_scalars(cfg)

    H0 = cfg.get("H_init")
    if H0 is None:
        H0 = kmeans_indicator_h(gen, V, k, dtype)  # seminmf.m:109-117
    W0 = cfg.get("W_init")
    if W0 is None:
        W0 = 2.0 * uniform_init(gen, (m, k), dtype, device, floor_eps=False) - 1.0  # seminmf.m:121
    W0 = as_tensor(W0, dtype, device)
    H0 = as_tensor(H0, dtype, device)

    with torch.no_grad():
        step = _make_step(V, sq_norm(V), bool(cfg.get("W_fixed", False)),
                          bool(cfg.get("H_fixed", False)))
        out = looplib.run(step, (W0, H0), maxiter, tolerance, cost_dtype=dtype)
    W, H = out.state
    return Result(fields=("W", "H", "cost"), W=W, H=H,
                  cost=looplib.trim_cost(out, maxiter),
                  n_iters=out.n_iters, converged=out.stopped)
