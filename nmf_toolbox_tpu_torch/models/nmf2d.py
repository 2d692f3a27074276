"""Two-dimensional deconvolutional NMF (Schmidt & Morup 2006, NMF2D).

PyTorch counterpart of ``nmf_toolbox_tpu/models/nmf2d.py``.  Beyond the
reference's time shifts (cnmf.m), each basis element may also shift DOWN
the (log-)frequency axis, modelling pitch transposition of a fixed
spectral shape:

    V ~ Lambda = sum_t sum_p shift_down(W[:, :, t], p) @ shift_right(H[:, :, p], t)

with W (m, k, T) time-varying spectral shapes and H (k, n, P) per-pitch
activations.  The reconstruction and both gradients are one GEMM over
P*T*k each (ops/shift.py: ``conv_reconstruct_2d``, ``conv_wt_phi_2d``,
``conv_phi_ht_2d``).  Update order, the diagonal renormalization-
correction terms and the cross-frame basis normalization follow cnmf's
naive step, so with ``pitch_len=1`` the trajectories reduce to cnmf's
(euclidean/IS/AB exactly; KL differs only by cnmf's no-shift quirk at
cnmf.m:220-224, a property of its unshifted ones field).
"""
from __future__ import annotations

import torch

from ..core import (Result, as_tensor, common_scalars, merge_config,
                    parse_cost_every, reject_mesh, resolve_device, resolve_dtype,
                    uniform_init)
from ..ops import divergence as dv
from ..ops import loop as looplib
from ..ops.normalize import cross_frame_norm
from ..ops.shift import conv_phi_ht_2d, conv_reconstruct_2d, conv_wt_phi_2d


def _renorm(W, H, T):
    """Cross-frame basis normalization per element over (m, T), cnmf's
    convention (so the pitch_len=1 reduction is exact); the norm transfers
    into every pitch slice of H."""
    Wn, norms = cross_frame_norm(W, None, T, return_norms=True)
    return Wn, (None if H is None else H * norms[:, None, None])


def _make_step(V, wsp, hsp, eps, div, a, b, T, P, w_fixed, h_fixed, ce, maxiter):
    finish = looplib.cost_cadence(ce, maxiter)

    def step(carry, i):
        W, H = carry[0], carry[1]  # W (m, k, T), H (k, n, P)
        if not w_fixed:
            phi_neg, phi_pos, power = dv.ab_fields(V, conv_reconstruct_2d(W, H), a, b)
            A = conv_phi_ht_2d(phi_neg, H, T)
            B = conv_phi_ht_2d(phi_pos, H, T)
            # cnmf's diagonal renormalization-correction terms
            dneg = torch.sum(W * B, dim=0)
            dpos = torch.sum(W * A, dim=0)
            neg = dv.apply_power(A + W * dneg[None], power)
            pos = dv.apply_power(B + W * dpos[None], power)
            W = W * (neg / torch.clamp_min(pos + wsp[None, :, None], eps))
            W, _ = _renorm(W, None, T)
        if not h_fixed:
            phi_neg, phi_pos, power = dv.ab_fields(V, conv_reconstruct_2d(W, H), a, b)
            gneg = dv.apply_power(conv_wt_phi_2d(W, phi_neg, P), power)  # (k, n, P)
            gpos = dv.apply_power(conv_wt_phi_2d(W, phi_pos, P), power)
            H = H * (gneg / torch.clamp_min(gpos + hsp[:, None, None], eps))

        def cost_fn(W=W, H=H):
            # the iteration's third 2-D reconstruction, dropped on the
            # skipped iterations of cost_every > 1
            c = dv.cost(div, V, conv_reconstruct_2d(W, H), a, b)
            return c + (torch.sum(wsp * torch.sum(torch.abs(W), dim=(0, 2)))
                        + torch.sum(hsp * torch.sum(torch.abs(H), dim=(1, 2))))
        return finish((W, H), carry, i, cost_fn)

    return step


def nmf2d(V, num_basis_elems: int, context_len: int, pitch_len: int,
          config: dict | None = None, **kwargs):
    """2-D deconvolutional NMF:
    V ~ sum_t sum_p shift_down(W[:, :, t], p) @ shift_right(H[:, :, p], t).

    ``pitch_len=1`` is cnmf.  Single source.  Parameters: divergence
    ('euclidean' | 'kl' | 'is' | 'ab' + alpha/beta, the alpha = 0 dual
    included; all with shifted fields), W_init (m, k, T), H_init
    (k, n, P), W_sparsity/H_sparsity (L1), W_fixed/H_fixed, maxiter (100),
    tolerance (1e-3), seed, dtype, eps, cost_every (evaluate the objective
    every N iterations; the factors are bit-identical), device (where a
    NumPy ``V`` goes; default the CUDA card).  ``mesh`` raises
    ``NotImplementedError``.  Returns a :class:`Result` (W, H, cost) with
    W (m, k, T) and H (k, n, P) tensors on the run's device.
    """
    cfg = merge_config(config, kwargs)
    reject_mesh(cfg)
    device = resolve_device(V, cfg.get("device"))
    dtype = resolve_dtype(V, cfg.get("dtype"))
    V = as_tensor(V, dtype, device)
    if V.ndim != 2:
        raise ValueError(f"nmf2d expects a 2-D V; got {tuple(V.shape)}")
    m, n = V.shape
    T, P = int(context_len), int(pitch_len)
    if T < 1 or P < 1:
        raise ValueError(f"context_len and pitch_len must be >= 1; got ({T}, {P})")
    if P > m:
        raise ValueError(f"pitch_len {P} exceeds the feature count {m}")
    if isinstance(num_basis_elems, (list, tuple)):
        raise TypeError("nmf2d is single-source; concatenate bases "
                        "externally for multi-source workflows")
    k = int(num_basis_elems)

    div = dv.canon(cfg.get("divergence", "euclidean"))
    alpha, beta = dv.ab_params(div, cfg.get("alpha", 1.0), cfg.get("beta", 1.0))
    if div == "ab" and alpha == 0.0 and beta == 0.0:
        raise ValueError("alpha = 0 and beta = 0 is not supported at this time.")
    w_sp = max(float(cfg.get("W_sparsity") or 0.0), 0.0)
    h_sp = max(float(cfg.get("H_sparsity") or 0.0), 0.0)
    maxiter, tolerance, eps, gen = common_scalars(cfg)

    W0 = cfg.get("W_init")
    if W0 is None:
        W0 = uniform_init(gen, (m, k, T), dtype, device)
        W0 = W0 / torch.sqrt(torch.sum(W0 * W0, dim=0, keepdim=True))
    W0 = as_tensor(W0, dtype, device)
    if tuple(W0.shape) != (m, k, T):
        raise ValueError(f"W_init has shape {tuple(W0.shape)}, expected {(m, k, T)}")
    H0 = cfg.get("H_init")
    if H0 is None:
        H0 = uniform_init(gen, (k, n, P), dtype, device)
    H0 = as_tensor(H0, dtype, device)
    if tuple(H0.shape) != (k, n, P):
        raise ValueError(f"H_init has shape {tuple(H0.shape)}, expected {(k, n, P)}")
    W0, H0 = _renorm(W0, H0, T)  # cnmf.m:157-166's convention

    ce = parse_cost_every(cfg)
    with torch.no_grad():
        step = _make_step(V, torch.full((k,), w_sp, dtype=dtype, device=device),
                          torch.full((k,), h_sp, dtype=dtype, device=device), eps,
                          div, alpha, beta, T, P, bool(cfg.get("W_fixed", False)),
                          bool(cfg.get("H_fixed", False)), ce, maxiter)
        out = looplib.run(step, looplib.cadence_state((W0, H0), ce, dtype),
                          maxiter, tolerance, cost_dtype=dtype, cost_every=ce)
    return Result(fields=("W", "H", "cost"), W=out.state[0], H=out.state[1],
                  cost=looplib.trim_cost(out, maxiter),
                  n_iters=out.n_iters, converged=out.stopped)
