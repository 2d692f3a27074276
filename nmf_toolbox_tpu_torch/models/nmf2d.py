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

Under a mesh only the samples shard (``parallel.placements_for("nmf2d")``
keeps the feature axis and W whole, so the pitch shifts stay local): H's
time shifts read the T - 1 columns before this rank's block and the left
shifts the T - 1 after it (``parallel.collectives.halo``), the W
gradients and the cost sum over samples.
"""
from __future__ import annotations

import torch

from ..core import (Result, as_tensor, common_scalars, merge_config,
                    parse_cost_every, resolve_device, resolve_dtype,
                    staging_device, uniform_init)
from ..ops import divergence as dv
from ..ops import loop as looplib
from ..ops.masking import region_mask
from ..ops.normalize import cross_frame_norm
from ..ops.shift import (conv_phi_ht_2d, conv_reconstruct_2d, conv_wt_phi_2d,
                         stack_pitch_shifts)
from ..parallel.collectives import gather_factor, sum_samples
from ..parallel.mesh import apply_placements, block_offset, check_mesh
from ..parallel.padding import pad_axes, plan_padding


def _renorm(W, H, T):
    """Cross-frame basis normalization per element over (m, T), cnmf's
    convention (so the pitch_len=1 reduction is exact); the norm transfers
    into every pitch slice of H."""
    Wn, norms = cross_frame_norm(W, None, T, return_norms=True)
    return Wn, (None if H is None else H * norms[:, None, None])


def _make_step(V, wsp, hsp, eps, div, a, b, T, P, w_fixed, h_fixed, ce, maxiter,
               valid=None, mesh=None, h_sparse=True):
    finish = looplib.cost_cadence(ce, maxiter)
    nv = None if valid is None else valid[1]
    mask = region_mask(V.shape, valid, V.device, (0, block_offset(mesh, V.shape[1])))

    def step(carry, i):
        W, H = carry[0], carry[1]  # W (m, k, T), H (k, n, P)
        Hs = stack_pitch_shifts(H, T, nv, mesh)  # both updates' reconstructions
        if not w_fixed:
            phi_neg, phi_pos, power = dv.ab_fields(V, conv_reconstruct_2d(W, H, Hs=Hs),
                                                   a, b, mask=mask)
            A, B = sum_samples(mesh, conv_phi_ht_2d(phi_neg, H, T, Hs),
                               conv_phi_ht_2d(phi_pos, H, T, Hs))
            # cnmf's diagonal renormalization-correction terms
            dneg = torch.sum(W * B, dim=0)
            dpos = torch.sum(W * A, dim=0)
            neg = dv.apply_power(A + W * dneg[None], power)
            pos = dv.apply_power(B + W * dpos[None], power)
            W = W * (neg / torch.clamp_min(pos + wsp[None, :, None], eps))
            W, _ = _renorm(W, None, T)
        if not h_fixed:
            phi_neg, phi_pos, power = dv.ab_fields(V, conv_reconstruct_2d(W, H, Hs=Hs),
                                                   a, b, mask=mask)
            gneg = dv.apply_power(conv_wt_phi_2d(W, phi_neg, P, mesh), power)  # (k, n, P)
            gpos = dv.apply_power(conv_wt_phi_2d(W, phi_pos, P, mesh), power)
            H = H * (gneg / torch.clamp_min(gpos + hsp[:, None, None], eps))

        def cost_fn(W=W, H=H):
            # the iteration's third 2-D reconstruction, dropped on the
            # skipped iterations of cost_every > 1; a 2-D mesh holds each
            # block on every rank of the feature axis, so the sums run
            # over samples only
            c = dv.cost(div, V, conv_reconstruct_2d(W, H, nv, mesh), a, b, mask=mask)
            ph = torch.sum(torch.abs(H), dim=(1, 2))
            if mesh is not None:
                c, ph = sum_samples(mesh, c, ph) if h_sparse else (sum_samples(mesh, c), ph)
            return c + (torch.sum(wsp * torch.sum(torch.abs(W), dim=(0, 2)))
                        + torch.sum(hsp * ph))
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
    NumPy ``V`` goes; default the CUDA card), mesh (``parallel.make_mesh``:
    every rank calls with the same arguments; the samples shard, zero-
    padded to the mesh's multiple, and every rank gets the whole W and
    H).  Returns a :class:`Result` (W, H, cost) with W (m, k, T) and H
    (k, n, P) tensors on the run's device.
    """
    cfg = merge_config(config, kwargs)
    mesh = check_mesh(cfg.get("mesh"))
    device = resolve_device(V, cfg.get("device"), mesh)
    dtype = resolve_dtype(V, cfg.get("dtype"))
    src = staging_device(V, device, mesh)  # the whole arrays until placement
    V = as_tensor(V, dtype, src)
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
        W0 = uniform_init(gen, (m, k, T), dtype, src)
        W0 = W0 / torch.sqrt(torch.sum(W0 * W0, dim=0, keepdim=True))
    W0 = as_tensor(W0, dtype, src)
    if tuple(W0.shape) != (m, k, T):
        raise ValueError(f"W_init has shape {tuple(W0.shape)}, expected {(m, k, T)}")
    H0 = cfg.get("H_init")
    if H0 is None:
        H0 = uniform_init(gen, (k, n, P), dtype, src)
    H0 = as_tensor(H0, dtype, src)
    if tuple(H0.shape) != (k, n, P):
        raise ValueError(f"H_init has shape {tuple(H0.shape)}, expected {(k, n, P)}")
    W0, H0 = _renorm(W0, H0, T)  # cnmf.m:157-166's convention

    _, pad_n, valid = plan_padding(mesh, m, n)
    if valid is not None:
        valid = (m, n)  # the feature axis is never padded for nmf2d
        V = pad_axes(V, {1: pad_n})
        H0 = pad_axes(H0, {1: pad_n})
    V, W0, H0 = apply_placements(mesh, "nmf2d", V=V, W=W0, H=H0)

    ce = parse_cost_every(cfg)
    with torch.no_grad():
        step = _make_step(V, torch.full((k,), w_sp, dtype=dtype, device=device),
                          torch.full((k,), h_sp, dtype=dtype, device=device), eps,
                          div, alpha, beta, T, P, bool(cfg.get("W_fixed", False)),
                          bool(cfg.get("H_fixed", False)), ce, maxiter, valid, mesh,
                          h_sp > 0)
        out = looplib.run(step, looplib.cadence_state((W0, H0), ce, dtype),
                          maxiter, tolerance, cost_dtype=dtype, cost_every=ce)
    return Result(fields=("W", "H", "cost"), W=out.state[0],
                  H=gather_factor(mesh, out.state[1], "n", 1)[:, :n],
                  cost=looplib.trim_cost(out, maxiter),
                  n_iters=out.n_iters, converged=out.stopped)
