"""Batched NMF: many small problems, or many restarts of one, in one solve.

PyTorch counterpart of the ``nmf_batched``, ``nmf_multiseed``,
``nmf_encode``, ``cnmf_encode``, ``nmf2d_encode`` and ``cmfwisa_encode``
engines of ``nmf_toolbox_tpu/models/batched.py``.  Serving factorizes
many small matrices (per-utterance spectrograms, per-user blocks) rather
than one large one; rank selection restarts one matrix many times.  The JAX engines ``vmap`` the single-problem step under
``lax.scan``; here each step is written on batched tensors — W (B, m, k),
H (B, k, n), and V (B, m, n) or one (m, n) shared by every restart — so
each product of an iteration is one batched matmul for all problems.
The convolutive encoders run H (B, k, n) or (B, k, n, P) through the
shift operators of ``ops/shift.py``, whose GEMMs broadcast over the batch,
and ``cmfwisa_encode`` a complex (B, m, n) batch through the fields of
``models/cmfwisa.py``.

Under a mesh (``parallel.make_mesh``) the problems shard over the
mesh's sample axis and every dictionary is replicated
(``parallel.placements_for``): each rank solves its own problems whole,
with no collective inside the loop, and the results are gathered on every
rank at the end.  ``nmf_multiseed``'s shared V shards over the feature
axis of a 2-D mesh instead, zero-padded to its multiple, and its W-side
column sums reduce over that axis.

The engines run a fixed iteration count with no stop rule (a converged
problem keeps iterating harmlessly; MU is a fixed point) and return one
cost trace per problem.  So the loop never reads the device: the (B,)
objective of each check iteration stays there and the (B, iters) trace
is fetched once at the end.  ``cost_every`` computes the objective only
on the check iterations of ``ops/loop.is_check`` and carries it in
between; the factor updates do not read it, so they stay bit-identical.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import (Result, as_list, as_tensor, common_scalars, complex_dtype_of,
                    merge_config, parse_cost_every, per_column, promote_per_source,
                    real_dtype_of, resolve_device, resolve_dtype, source_blocks,
                    staging_device, torch_dtype, uniform_init, unwrap_sources)
from ..ops import divergence as dv
from ..ops import loop as looplib
from ..ops.masking import region_mask
from ..parallel.collectives import gather_factor, sum_features
from ..parallel.mesh import apply_placements, check_mesh, shard
from ..parallel.padding import mesh_multiples, pad_amount, pad_axes
from ..ops.gram import (conv_cross_grams_w, conv_euclidean_cost_gram,
                        conv_wt_vhat_gram, euclidean_cost_gram, sq_norm, vdot)
from ..ops.normalize import cross_frame_norm, unit_l2_columns
from ..ops.shift import (conv_reconstruct, conv_reconstruct_2d, conv_wt_phi,
                         conv_wt_phi_2d)
from .cmfwisa import complex_cost, per_source_wh, phase_fields, unit_phase

MATRIX = (-2, -1)  # the dimensions a per-problem sum runs over


class _Spec(NamedTuple):
    iters: int
    eps: float
    div: str = "euclidean"
    inner: int = 1
    cost_every: int = 1


class _EncSpec(NamedTuple):
    iters: int
    eps: float
    div: str = "euclidean"
    alpha: float = 1.0
    beta: float = 1.0
    cost_every: int = 1
    P: int = 1  # nmf2d_encode's pitch shifts


def _v_ht(V, H):
    """V @ H' for every problem.  A V shared by S restarts meets all of
    them in one GEMM, (S*k, n) @ (n, m), so it is read once per product
    and never copied S times."""
    if V.ndim == 3:
        return vdot(V, H.mT, V.dtype)
    S, k, n = H.shape
    return vdot(H.reshape(S * k, n), V.T, V.dtype).reshape(S, k, -1).mT


def _wt_v(W, V):
    """W' @ V for every problem; a shared V as in :func:`_v_ht`,
    (S*k, m) @ (m, n)."""
    if V.ndim == 3:
        return vdot(W.mT, V, V.dtype)
    S, m, k = W.shape
    return vdot(W.mT.reshape(S * k, m), V, V.dtype).reshape(S, k, -1)


def _euclid_step(V, v_sq, eps, inner, mesh=None):
    """Gram-form euclid MU iteration on every problem at once (nmf.m:149-186
    update structure, W-normalization gradient coupling included).
    ``inner`` repeats each factor update reusing the V-dependent Grams
    (accelerated MU, as ``nmf(method='gram', inner_iters=)``).  The
    objective comes from the Grams the update already formed.  ``mesh``:
    V and W hold this rank's rows (``nmf_multiseed`` on a 2-D mesh), and
    the sums over m reduce over the feature axis."""
    def step(state):
        W, H = state
        HHt = H @ H.mT
        VHt = _v_ht(V, H)
        for _ in range(inner):
            WG = W @ HHt
            dneg, dpos = sum_features(mesh, torch.sum(W * WG, dim=-2, keepdim=True),
                                      torch.sum(W * VHt, dim=-2, keepdim=True))
            W = W * ((VHt + W * dneg) / torch.clamp_min(WG + W * dpos, eps))
            W = unit_l2_columns(W, mesh)
        WtV, WtW = sum_features(mesh, _wt_v(W, V), W.mT @ W)
        for _ in range(inner):
            H = H * (WtV / torch.clamp_min(WtW @ H, eps))
        return (W, H), lambda: euclidean_cost_gram(v_sq, WtV, WtW, H, dim=MATRIX)
    return step


def _kl_step(V, eps, mesh=None, mask=None):
    """Field-form KL MU iteration on every problem, matching the single
    solver's naive step (nmf.m:147-199 with the implicit ones field).
    ``mesh`` as in :func:`_euclid_step`; ``mask`` zeroes the 0/0 ratio
    fields of V's zero-padded rows."""
    def ratio(W, H):
        R = V / (W @ H)
        return R if mask is None else torch.where(mask, R, torch.zeros((), dtype=R.dtype,
                                                                     device=R.device))

    def step(state):
        W, H = state
        A = ratio(W, H) @ H.mT
        h_sum = torch.sum(H, dim=-1)[..., None, :]  # ones(m, n) @ H'
        dneg, dpos = sum_features(mesh, torch.sum(W * h_sum, dim=-2, keepdim=True),
                                  torch.sum(W * A, dim=-2, keepdim=True))
        W = W * ((A + W * dneg) / torch.clamp_min(h_sum + W * dpos, eps))
        W = unit_l2_columns(W, mesh)
        WtR, w_sum = sum_features(mesh, W.mT @ ratio(W, H),
                                  torch.sum(W, dim=-2)[..., :, None])  # W' @ ones(m, n)
        H = H * (WtR / torch.clamp_min(w_sum, eps))
        return (W, H), lambda: sum_features(
            mesh, dv.cost("kl", V, W @ H, mask=mask, dim=MATRIX))
    return step


def _scan(step, state, iters, ce, cost_dtype):
    """``iters`` iterations of ``step(state) -> (state, cost_fn)``; the (B,)
    objective ``cost_fn()`` is computed on the check iterations of
    ``cost_every=ce`` and carried in between.  Reads nothing from the
    device.  Returns (state, costs (B, iters))."""
    cols, last = [], None
    for i in range(iters):
        state, cost_fn = step(state)
        if looplib.is_check(i, ce, iters):
            last = cost_fn().to(cost_dtype)
        cols.append(last)
    return state, torch.stack(cols, dim=1)


def _solve(spec: _Spec, V, W0, H0, mesh=None, mask=None):
    """The solve of ``nmf_batched`` (V (B, m, n)) and ``nmf_multiseed``
    (V (m, n), shared) on device tensors, with no host sync.  Returns
    (W, H, costs (B, iters)) on the device.  ``mesh``: V and W hold this
    rank's rows (a multiseed V sharded over features), ``mask`` the valid
    rows of a padded V."""
    if spec.div == "euclidean":
        v_sq = sum_features(mesh, sq_norm(V.to(W0.dtype), dim=MATRIX))  # once per problem
        step = _euclid_step(V, v_sq, spec.eps, spec.inner, mesh)
    else:
        step = _kl_step(V, spec.eps, mesh, mask)
    cdt = torch.promote_types(W0.dtype, torch.float32)
    with torch.no_grad():
        (W, H), costs = _scan(step, (W0, H0), spec.iters, spec.cost_every, cdt)
    return W, H, costs


def _solve_encode(spec: _EncSpec, Vs, W, H0, hsp, Mw=None):
    """H-only MU of every problem against ONE fixed dictionary W (m, k), on
    device tensors, with no host sync.  Returns (H, costs (B, iters)).

    Euclidean without weights runs in Gram space after a one-time W'V per
    problem, so its iterations never touch V.  The field divergences
    (kl / is / ab, the alpha = 0 dual included) and every weighted run
    re-read V for the ratio fields each iteration (nmf.m:176-199), with
    KL's ones-field denominator W'1 (nmf.m:184) hoisted out of the loop.
    """
    a, b, eps = spec.alpha, spec.beta, spec.eps
    cdt = torch.promote_types(W.dtype, torch.float32)

    def penalty(H):
        """The H_sparsity cost term (nmf.m:216-218), per problem."""
        return torch.sum(hsp * torch.sum(torch.abs(H), dim=-1), dim=-1)

    if spec.div == "euclidean" and Mw is None:
        v_sq = sq_norm(Vs.to(W.dtype), dim=MATRIX)
        WtV = vdot(W.T, Vs, Vs.dtype)  # (B, k, n); the loop is V-free
        WtW = W.T @ W

        def step(H):
            H = H * (WtV / torch.clamp_min(WtW @ H + hsp[:, None], eps))
            return H, lambda: (euclidean_cost_gram(v_sq, WtV, WtW, H, dim=MATRIX)
                               + penalty(H))
    else:
        kl_pos = torch.sum(W, dim=0)[:, None]  # W' @ ones(m, n), hoisted

        def step(H):
            phi_neg, phi_pos, power = dv.fields(spec.div, Vs, W @ H, a, b,
                                                weights=Mw)
            neg = dv.apply_power(W.T @ phi_neg, power)
            pos = dv.apply_power(kl_pos if phi_pos is None else W.T @ phi_pos,
                                 power)
            H = H * (neg / torch.clamp_min(pos + hsp[:, None], eps))
            return H, lambda: (dv.cost(spec.div, Vs, W @ H, a, b, weights=Mw,
                                       dim=MATRIX) + penalty(H))

    with torch.no_grad():
        return _scan(step, H0, spec.iters, spec.cost_every, cdt)


def _solve_conv_encode(spec: _EncSpec, Vs, W, H0, hsp, Mw=None):
    """H-only convolutive MU of every problem against ONE dictionary W
    (m, k, T), on device tensors, with no host sync.  Per problem it is
    ``cnmf(V_i, k, T, W_init=W, W_fixed=True)``: euclidean without
    weights follows cnmf's Gram step, whose only V term conv_wt_phi(W, V)
    is loop-invariant and computed once, so its iterations run in
    (T, T, k, k) Gram space; KL without weights follows cnmf's naive step
    with the reference's no-shift ones field (cnmf.m:220-224), sum(W)
    hoisted; the other divergences and every weighted run recompute both
    shifted fields.  Returns (H, costs (B, iters))."""
    a, b, eps = spec.alpha, spec.beta, spec.eps
    cdt = torch.promote_types(W.dtype, torch.float32)

    def penalty(H):
        return torch.sum(hsp * torch.sum(torch.abs(H), dim=-1), dim=-1)

    if spec.div == "euclidean" and Mw is None:
        v_sq = sq_norm(Vs, dim=MATRIX)
        WW = conv_cross_grams_w(W)       # (T, T, k, k)
        Gneg = conv_wt_phi(W, Vs)        # (B, k, n), once

        def step(H):
            H = H * (Gneg / torch.clamp_min(conv_wt_vhat_gram(WW, H) + hsp[:, None], eps))
            # the objective's own cross-Grams of H, skipped under cost_every > 1
            return H, lambda: conv_euclidean_cost_gram(v_sq, Gneg, WW, H) + penalty(H)
    else:
        kl_pos = torch.sum(W, dim=(0, 2))[:, None] if spec.div == "kl" and Mw is None else None

        def step(H):
            phi_neg, phi_pos, power = dv.ab_fields(Vs, conv_reconstruct(W, H), a, b,
                                                   weights=Mw)
            gneg = dv.apply_power(conv_wt_phi(W, phi_neg), power)
            gpos = kl_pos if kl_pos is not None else dv.apply_power(
                conv_wt_phi(W, phi_pos), power)
            H = H * (gneg / torch.clamp_min(gpos + hsp[:, None], eps))
            return H, lambda: (dv.cost(spec.div, Vs, conv_reconstruct(W, H), a, b,
                                       weights=Mw, dim=MATRIX) + penalty(H))

    with torch.no_grad():
        return _scan(step, H0, spec.iters, spec.cost_every, cdt)


def _solve_nmf2d_encode(spec: _EncSpec, Vs, W, H0, hsp):
    """H-only 2-D deconvolutional MU of every problem against ONE
    dictionary W (m, k, T) with ``spec.P`` pitch shifts, on device
    tensors, with no host sync: per problem ``nmf2d(V_i, k, T, P,
    W_init=W, W_fixed=True)``.  Loop-invariant: euclidean's V gradient
    and KL's shifted ones-field gradient.  Returns (H, costs (B, iters))."""
    a, b, eps, P = spec.alpha, spec.beta, spec.eps, spec.P
    cdt = torch.promote_types(W.dtype, torch.float32)
    gneg_v = conv_wt_phi_2d(W, Vs, P) if spec.div == "euclidean" else None
    gpos_kl = None
    if spec.div == "kl":
        gpos_kl = conv_wt_phi_2d(W, torch.ones(Vs.shape[1:], dtype=W.dtype,
                                               device=W.device), P)

    def step(H):
        phi_neg, phi_pos, power = dv.ab_fields(Vs, conv_reconstruct_2d(W, H), a, b)
        gneg = gneg_v if gneg_v is not None else conv_wt_phi_2d(W, phi_neg, P)
        gpos = gpos_kl if gpos_kl is not None else conv_wt_phi_2d(W, phi_pos, P)
        gneg, gpos = dv.apply_power(gneg, power), dv.apply_power(gpos, power)
        H = H * (gneg / torch.clamp_min(gpos + hsp[:, None, None], eps))
        return H, lambda: (dv.cost(spec.div, Vs, conv_reconstruct_2d(W, H), a, b,
                                   dim=MATRIX)
                           + torch.sum(hsp * torch.sum(torch.abs(H), dim=(-2, -1)), dim=-1))

    with torch.no_grad():
        return _scan(step, H0, spec.iters, spec.cost_every, cdt)


# ---------------------------------------------------------------------------
# Validators and placement (the JAX package's)
# ---------------------------------------------------------------------------

def _data_dtype_of(cfg, div, name):
    """Validate data_dtype (bf16 V storage; euclid-only — the KL ratio
    field needs V at compute precision, matching nmf()'s contract)."""
    dd = cfg.get("data_dtype")
    if dd is None:
        return None
    if div != "euclidean":
        raise ValueError(f"{name}: data_dtype is only supported with "
                         "the euclidean divergence")
    return torch_dtype(dd)


def _encode_weights_of(cfg, B, m, n, name, dtype, src, mesh, solver):
    """Validate the encode engine's optional per-entry weights: (m, n)
    shared across the batch or (B, m, n) per problem; nonnegative and
    NaN-free (weight 0 = missing entry).  Either shape broadcasts against
    the batch.  They are checked on ``src`` and placed like V (batched)
    or like the dictionary (shared) on a mesh."""
    Mw = cfg.get("weights")
    if Mw is None:
        return None
    Mw = as_tensor(Mw, dtype, src)
    if tuple(Mw.shape) not in ((m, n), (B, m, n)):
        raise ValueError(
            f"{name}: weights must be (m, n) = {(m, n)} shared across the "
            f"batch or (B, m, n) = {(B, m, n)} per problem; got {tuple(Mw.shape)}")
    if bool(torch.any(Mw < 0) | torch.any(torch.isnan(Mw))):
        raise ValueError(
            "weights must be nonnegative and NaN-free; to down-weight or "
            "drop an entry use weight 0 (padding.prepare_weights contract)")
    if mesh is None:
        return Mw
    return (apply_placements(mesh, solver, V=Mw) if Mw.ndim == 3
            else shard(mesh, Mw, ()))


def _check_batch_mesh(B, mesh, name):
    """Friendly divisibility error (mirrors nmf_multiseed's S check)."""
    if mesh is None:
        return
    _, nmul = mesh_multiples(mesh)
    if B % nmul:
        raise ValueError(
            f"{name}: batch size B={B} must be a multiple of the mesh's "
            f"sample axis ({nmul}): problems shard over it. Pad the batch "
            "or use a smaller mesh.")


def _ingest(Vs, cfg, dtype_of=None):
    """(mesh, device, src, dtype) of an engine call: the run's device,
    and ``src`` where the whole arrays stay until placement (the run's
    device with no mesh, see ``core.staging_device``)."""
    mesh = check_mesh(cfg.get("mesh"))
    device = resolve_device(Vs, cfg.get("device"), mesh)
    dtype = resolve_dtype(Vs, cfg.get("dtype"))
    return mesh, device, staging_device(Vs, device, mesh), dtype


def _gather(mesh, *xs):
    """Each per-problem result's whole batch, on every rank."""
    out = tuple(gather_factor(mesh, x, "n", 0) for x in xs)
    return out if len(out) > 1 else out[0]


def _reject_encode_config(cfg, name):
    """The encode engine fits H only, for a fixed iteration count; error
    rather than silently ignore options that cannot apply (the CLI's
    convention)."""
    fixed_w = "the dictionary W is the positional argument and is always fixed"
    msgs = {
        "W_fixed": fixed_w,
        "W_init": fixed_w,
        "W_sparsity": fixed_w,
        "H_fixed": "encoding fits H — with H also fixed there is nothing "
                   "to solve",
        "inner_iters": "accelerated MU repeats the W phase, which encode "
                       "does not run",
    }
    for key, why in msgs.items():
        if cfg.get(key) is not None:
            raise ValueError(f"{name}: {key!r} does not apply — {why}")


def _inner_of(cfg, div, name):
    """Validate inner_iters (accelerated MU is euclid-Gram-only,
    matching nmf()'s contract)."""
    inner = int(cfg.get("inner_iters", 1) or 1)
    if inner < 1:
        raise ValueError("inner_iters must be >= 1")
    if inner > 1 and div != "euclidean":
        raise ValueError(
            f"{name}: inner_iters > 1 (accelerated MU) requires the "
            "euclidean divergence")
    return inner


def _euclid_or_kl(cfg, name):
    div = dv.canon(cfg.get("divergence", "euclidean"))
    if div not in ("euclidean", "kl"):
        raise ValueError(
            f"{name} supports divergence 'euclidean' or 'kl'; got "
            f"{cfg.get('divergence')!r} (use the single-matrix nmf() for "
            "the IS/AB families)")
    return div


def _inits(cfg, gen, shape, dtype, device, axis):
    """W_init (B, m, k) and H_init (B, k, n), each given or uniform from
    ``gen``; ``axis`` names the leading axis in the shape error.  The
    caller brings W's columns to unit L2 (nmf.m:132-134) once they are
    placed."""
    B, m, n, k = shape
    W0, H0 = cfg.get("W_init"), cfg.get("H_init")
    W0 = uniform_init(gen, (B, m, k), dtype, device) if W0 is None else as_tensor(W0, dtype, device)
    H0 = uniform_init(gen, (B, k, n), dtype, device) if H0 is None else as_tensor(H0, dtype, device)
    if tuple(W0.shape) != (B, m, k) or tuple(H0.shape) != (B, k, n):
        raise ValueError(
            f"inits must carry a leading {axis} axis: W_init {(B, m, k)}, "
            f"H_init {(B, k, n)}; got {tuple(W0.shape)}, {tuple(H0.shape)}")
    return W0, H0


def _result(W, H, costs, maxiter):
    return Result(fields=("W", "H", "cost"), W=W, H=H,
                  cost=costs.cpu().numpy(), n_iters=maxiter, converged=False)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def nmf_batched(Vs, num_basis_elems: int, config: dict | None = None,
                **kwargs):
    """NMF over a batch Vs of shape (B, m, n).

    Parameters: divergence ('euclidean' | 'kl' — KL is the spectrogram
    serving objective), W_init (B, m, k), H_init (B, k, n), maxiter
    (100), inner_iters (accelerated MU, euclid only), seed, dtype, eps,
    data_dtype (bf16 V storage, euclid only), cost_every (int, default 1:
    evaluate the objective trace every N iterations, carrying the last
    value in between — the factor trajectory is bit-identical; for KL the
    skipped evaluations drop the objective's (m, n) reconstruction and
    log pass), device (where a NumPy Vs goes; default the CUDA card).
    ``device_output`` is accepted and changes nothing: the factors stay
    on the run's device anyway.  ``mesh``: problems shard over the mesh's
    sample axis (B must be a multiple of it).
    Returns Result with W (B, m, k), H (B, k, n) tensors on the run's
    device and cost (B, maxiter), NumPy — one trace per problem.
    """
    cfg = merge_config(config, kwargs)
    div = _euclid_or_kl(cfg, "nmf_batched")
    mesh, device, src, dtype = _ingest(Vs, cfg)
    Vs = as_tensor(Vs, dtype, src)
    if Vs.ndim != 3:
        raise ValueError(f"nmf_batched expects (B, m, n); got {tuple(Vs.shape)}")
    B, m, n = Vs.shape
    _check_batch_mesh(B, mesh, "nmf_batched")
    k = int(num_basis_elems)
    maxiter, _, eps, gen = common_scalars(cfg)
    W0, H0 = _inits(cfg, gen, (B, m, n, k), dtype, src, "batch")
    dd = _data_dtype_of(cfg, div, "nmf_batched")
    if dd is not None:
        Vs = Vs.to(dd)  # storage dtype; factors stay at compute dtype
    spec = _Spec(maxiter, eps, div, _inner_of(cfg, div, "nmf_batched"),
                 parse_cost_every(cfg))
    Vs, W0, H0 = apply_placements(mesh, "nmf_batched", V=Vs, W=W0, H=H0)
    W, H, costs = _solve(spec, Vs, unit_l2_columns(W0), H0)  # nmf.m:132-134
    return _result(*_gather(mesh, W, H, costs), maxiter)


def nmf_multiseed(V, num_basis_elems: int, n_seeds: int,
                  config: dict | None = None, **kwargs):
    """NMF of ONE matrix from ``n_seeds`` random restarts.

    All restarts run as one batched solve with V shared: each product
    that reads V is one GEMM over every restart (``_v_ht``, ``_wt_v``),
    so V is read once per product and never copied S times.  This is the
    engine of consensus rank selection (rank.py).  Parameters: divergence
    ('euclidean' | 'kl' — Brunet 2004's consensus method is classically
    KL), maxiter (100), inner_iters (accelerated MU, euclid only), seed,
    dtype, eps, data_dtype (euclid only), W_init/H_init with a leading
    (S,) axis, device; ``device_output`` changes nothing.  ``mesh``:
    restarts shard over the mesh's sample axis (S must be a multiple of
    it), V over its feature axis, zero-padded to that axis' multiple (zero
    W rows are absorbing; KL masks the pad rows' 0/0 fields).  Returns
    Result with W (S, m, k), H (S, k, n) tensors on the run's device and
    cost (S, maxiter), NumPy.
    """
    cfg = merge_config(config, kwargs)
    div = _euclid_or_kl(cfg, "nmf_multiseed")
    mesh, device, src, dtype = _ingest(V, cfg)
    V = as_tensor(V, dtype, src)
    if V.ndim != 2:
        raise ValueError(f"nmf_multiseed expects (m, n); got {tuple(V.shape)}")
    m, n = V.shape
    k = int(num_basis_elems)
    S = int(n_seeds)
    if S < 1:
        raise ValueError(f"n_seeds must be >= 1; got {n_seeds}")
    maxiter, _, eps, gen = common_scalars(cfg)
    W0, H0 = _inits(cfg, gen, (S, m, n, k), dtype, src, "seed")
    pad_m = 0
    if mesh is not None:
        mmul, nmul = mesh_multiples(mesh)
        if S % nmul:
            raise ValueError(
                f"n_seeds={S} must be a multiple of the mesh's sample "
                f"axis ({nmul}): restarts shard over it. Round n_seeds "
                f"up or use a smaller mesh.")
        pad_m = pad_amount(m, mmul)
        if pad_m:
            V = pad_axes(V, {0: pad_m})
            W0 = pad_axes(W0, {1: pad_m})
    dd = _data_dtype_of(cfg, div, "nmf_multiseed")
    if dd is not None:
        V = V.to(dd)  # storage dtype; factors stay at compute dtype
    spec = _Spec(maxiter, eps, div, _inner_of(cfg, div, "nmf_multiseed"))
    V, W0, H0 = apply_placements(mesh, "nmf_multiseed", V=V, W=W0, H=H0)
    mask = None
    if pad_m:  # the valid rows of this rank's block of the padded V
        mask = region_mask(V.shape, (m, n), V.device,
                           (mesh.coord("m") * V.shape[0], 0))
    W, H, costs = _solve(spec, V, unit_l2_columns(W0, mesh), H0, mesh, mask)
    W = gather_factor(mesh, W, "m", 1)[:, :m]
    return _result(*_gather(mesh, W, H, costs), maxiter)


def nmf_encode(Vs, W, config: dict | None = None, **kwargs):
    """Encode a batch Vs (B, m, n) against ONE frozen dictionary W (m, k).

    The deployment half of serving: ``nmf()`` trains the dictionary once;
    this runs the H-only multiplicative updates of all B incoming
    matrices as one batched solve.  Per-problem trajectories are exactly
    ``nmf(V_i, k, W_init=W, W_fixed=True)`` (nmf.m:51-60), including the
    entry unit-L2 column normalization of W (nmf.m:132-134; the identity
    for a dictionary ``nmf()`` trained).  Euclidean iterations never
    touch V: after a one-time W'V per problem each step is a (k, k) x
    (k, n) Gram-space update.

    Parameters: divergence ('euclidean' | 'kl' | 'is' | 'ab', the alpha =
    0 AB dual included), alpha/beta (AB), H_init (B, k, n) or a
    per-source list, H_sparsity (scalar or per source: L1 penalty on H),
    weights ((m, n) shared or (B, m, n) per problem, nonnegative;
    weight 0 marks a missing entry), maxiter (100), seed, dtype, eps,
    data_dtype (bf16 V storage, euclid only, not with weights),
    cost_every (as in :func:`nmf_batched`; for the field divergences the
    skipped evaluations drop the objective's (m, n) reconstruction and
    divergence pass), device; ``device_output`` changes nothing; ``mesh``:
    problems shard over the mesh's sample axis (B a multiple of it), the
    dictionary is replicated.  W may be a LIST of
    per-source dictionaries (cell-array semantics, nmf.m:114-116): they
    concatenate along the basis axis and W/H come back as per-source
    lists.  Returns Result with W (m, k, the normalized dictionary) and
    H (B, k, n) tensors on the run's device and cost (B, maxiter), NumPy.
    """
    cfg = merge_config(config, kwargs)
    div = dv.canon(cfg.get("divergence", "euclidean"))
    alpha = float(cfg.get("alpha", 1.0))
    beta = float(cfg.get("beta", 1.0))
    if div == "ab" and alpha == 0.0 and beta == 0.0:
        raise ValueError("alpha = 0 and beta = 0 is not supported at this time.")
    _reject_encode_config(cfg, "nmf_encode")
    mesh, device, src, dtype = _ingest(Vs, cfg)
    Vs = as_tensor(Vs, dtype, src)
    if Vs.ndim != 3:
        raise ValueError(f"nmf_encode expects Vs of shape (B, m, n); got "
                         f"{tuple(Vs.shape)} (encode a single matrix with "
                         "nmf(V, k, W_init=W, W_fixed=True))")
    B, m, n = Vs.shape
    _check_batch_mesh(B, mesh, "nmf_encode")
    w_list, w_was_seq = as_list(W)
    w_list = [as_tensor(w, dtype, src) for w in w_list]
    S = len(w_list)
    for s, w in enumerate(w_list):
        if w.ndim != 2 or w.shape[0] != m:
            raise ValueError(f"dictionary W[{s}] must be (m, k) = ({m}, k); "
                             f"got {tuple(w.shape)}")
    ks = [w.shape[1] for w in w_list]
    blocks = source_blocks(ks)
    W = torch.cat(w_list, dim=1)
    k = W.shape[1]
    maxiter, _, eps, gen = common_scalars(cfg)

    H0 = cfg.get("H_init")
    if H0 is None:
        H0 = uniform_init(gen, (B, k, n), dtype, src)
    elif isinstance(H0, (list, tuple)):
        if len(H0) != S:
            raise ValueError(f"Requested {S} sources. Given {len(H0)} "
                             "initial encoding matrices.")
        H0 = torch.cat([as_tensor(h, dtype, src) for h in H0], dim=1)
    H0 = as_tensor(H0, dtype, src)
    if tuple(H0.shape) != (B, k, n):
        raise ValueError(f"H_init must be {(B, k, n)}; got {tuple(H0.shape)}")
    h_sp = [max(float(v), 0.0) for v in
            promote_per_source(cfg.get("H_sparsity"), S, "H_sparsity", 0.0)]
    hsp = per_column(h_sp, ks, dtype, device)

    dd = _data_dtype_of(cfg, div, "nmf_encode")
    if dd is not None:
        if cfg.get("weights") is not None:
            raise ValueError("nmf_encode: data_dtype is not supported with "
                             "weights= (the weighted fields read V at "
                             "compute precision, matching nmf()'s contract)")
        Vs = Vs.to(dd)  # storage dtype; factors stay at compute dtype
    Mw = _encode_weights_of(cfg, B, m, n, "nmf_encode", dtype, src, mesh,
                            "nmf_encode")

    spec = _EncSpec(maxiter, eps, div, alpha, beta, parse_cost_every(cfg))
    Vs, W, H0 = apply_placements(mesh, "nmf_encode", V=Vs, W=W, H=H0)
    W = unit_l2_columns(W)  # nmf.m:132-134
    H, costs = _gather(mesh, *_solve_encode(spec, Vs, W, H0, hsp, Mw))
    return _result(unwrap_sources(W, blocks, 1, w_was_seq),
                   unwrap_sources(H, blocks, 1, w_was_seq), costs, maxiter)


def _encode_prelude(cfg, Vs, name, single):
    """The config checks the convolutive encoders share, then Vs as a
    (B, m, n) tensor on ``src``: (div, alpha, beta, Vs, mesh, device,
    src)."""
    div = dv.canon(cfg.get("divergence", "euclidean"))
    alpha, beta = dv.ab_params(div, cfg.get("alpha", 1.0), cfg.get("beta", 1.0))
    if div == "ab" and alpha == 0.0 and beta == 0.0:
        raise ValueError("alpha = 0 and beta = 0 is not supported at this time.")
    _reject_encode_config(cfg, name)
    if cfg.get("data_dtype") is not None:
        raise ValueError(f"{name}: data_dtype is not supported — the one-time V "
                         "gradient and the field paths read V at compute precision")
    mesh, device, src, dtype = _ingest(Vs, cfg)
    Vs = as_tensor(Vs, dtype, src)
    if Vs.ndim != 3:
        raise ValueError(f"{name} expects Vs of shape (B, m, n); got "
                         f"{tuple(Vs.shape)} (encode a single matrix with {single})")
    _check_batch_mesh(Vs.shape[0], mesh, name)
    return div, alpha, beta, Vs, mesh, device, src


def cnmf_encode(Vs, W, config: dict | None = None, **kwargs):
    """Encode a batch Vs (B, m, n) against ONE frozen CONVOLUTIVE
    dictionary W (m, k, T): the serving decoder for dictionaries ``cnmf``
    trained (each incoming spectrogram fits only its encoding).

    Per-problem trajectories are exactly ``cnmf(V_i, k, T, W_init=W,
    W_fixed=True)``, including the entry cross-frame normalization of W
    (cnmf.m:157-166; its norms move into the H inits, the identity for a
    dictionary ``cnmf`` trained) and, for KL, the reference's no-shift
    ones-field quirk (cnmf.m:220-224).  Euclidean iterations never touch
    V: after a one-time conv_wt_phi(W, V) per problem each step runs in
    (T, T, k, k) Gram space.

    Parameters: divergence ('euclidean' | 'kl' | 'is' | 'ab' with
    alpha/beta, the alpha = 0 dual included), H_init (B, k, n) or a
    per-source list, H_sparsity (scalar or per source), weights ((m, n)
    shared or (B, m, n) per problem, nonnegative; the positive field is
    then shifted, as in ``cnmf``), maxiter (100), seed, dtype, eps,
    cost_every (objective every N iterations; H is bit-identical), device,
    mesh (problems shard over its sample axis, as in :func:`nmf_encode`;
    each problem is whole on one rank, so no halo); ``device_output``
    changes nothing and ``data_dtype`` is rejected.  W may be a LIST of
    per-source dictionaries sharing one T; W/H then return as per-source
    lists.  Returns Result with W (m, k, T, normalized) and H (B, k, n)
    tensors on the run's device and cost (B, maxiter), NumPy.
    """
    cfg = merge_config(config, kwargs)
    div, alpha, beta, Vs, mesh, device, src = _encode_prelude(
        cfg, Vs, "cnmf_encode", "cnmf(V, k, T, W_init=W, W_fixed=True)")
    B, m, n = Vs.shape
    dtype = Vs.dtype
    w_list, w_was_seq = as_list(W)
    w_list = [as_tensor(w, dtype, src) for w in w_list]
    S = len(w_list)
    for s, w in enumerate(w_list):
        if w.ndim != 3 or w.shape[0] != m:
            raise ValueError(f"convolutive dictionary W[{s}] must be (m, k, T) "
                             f"with m = {m}; got {tuple(w.shape)}")
        if w.shape[2] != w_list[0].shape[2]:
            raise ValueError("all source dictionaries must share the same context "
                             f"length; got T={w.shape[2]} vs {w_list[0].shape[2]}")
    ks = [w.shape[1] for w in w_list]
    blocks = source_blocks(ks)
    W = torch.cat(w_list, dim=1)
    k, T = W.shape[1], W.shape[2]
    maxiter, _, eps, gen = common_scalars(cfg)

    H0 = cfg.get("H_init")
    if H0 is None:
        H0 = uniform_init(gen, (B, k, n), dtype, src)
    elif isinstance(H0, (list, tuple)):
        if len(H0) != S:
            raise ValueError(f"Requested {S} sources. Given {len(H0)} "
                             "initial encoding matrices.")
        H0 = torch.cat([as_tensor(h, dtype, src) for h in H0], dim=1)
    H0 = as_tensor(H0, dtype, src)
    if tuple(H0.shape) != (B, k, n):
        raise ValueError(f"H_init must be {(B, k, n)}; got {tuple(H0.shape)}")
    h_sp = [max(float(v), 0.0) for v in
            promote_per_source(cfg.get("H_sparsity"), S, "H_sparsity", 0.0)]
    hsp = per_column(h_sp, ks, dtype, device)
    Mw = _encode_weights_of(cfg, B, m, n, "cnmf_encode", dtype, src, mesh,
                            "cnmf_encode")

    spec = _EncSpec(maxiter, eps, div, alpha, beta, parse_cost_every(cfg))
    Vs, W, H0 = apply_placements(mesh, "cnmf_encode", V=Vs, W=W, H=H0)
    W, H0 = cross_frame_norm(W, H0, T)  # cnmf.m:157-166, W_fixed included
    H, costs = _gather(mesh, *_solve_conv_encode(spec, Vs, W, H0, hsp, Mw))
    return _result(unwrap_sources(W, blocks, 1, w_was_seq),
                   unwrap_sources(H, blocks, 1, w_was_seq), costs, maxiter)


def nmf2d_encode(Vs, W, pitch_len: int, config: dict | None = None, **kwargs):
    """Encode a batch Vs (B, m, n) against ONE frozen 2-D deconvolutional
    dictionary W (m, k, T) with ``pitch_len`` frequency shifts: batched
    pitch-invariant transcription, each problem's H (k, n, P) a piano roll
    of the frozen note shapes.

    Per-problem trajectories are exactly ``nmf2d(V_i, k, T, P, W_init=W,
    W_fixed=True)``, including the entry cross-frame normalization with
    norm transfer into every problem's H init.  Euclidean iterations
    never read V after a one-time per-problem gradient; KL hoists its
    shifted ones-field gradient.

    Parameters: divergence ('euclidean' | 'kl' | 'is' | 'ab' with
    alpha/beta, the alpha = 0 dual included), H_init (B, k, n, P),
    H_sparsity (scalar), maxiter (100), seed, dtype, eps, cost_every,
    device, mesh (problems shard over its sample axis, as in
    :func:`nmf_encode`); ``device_output`` changes nothing, ``weights``
    and ``data_dtype`` are rejected.  Returns Result with W (m, k, T, normalized)
    and H (B, k, n, P) tensors on the run's device and cost (B, maxiter),
    NumPy.
    """
    cfg = merge_config(config, kwargs)
    div, alpha, beta, Vs, mesh, device, src = _encode_prelude(
        cfg, Vs, "nmf2d_encode", "nmf2d(V, k, T, P, W_init=W, W_fixed=True)")
    if cfg.get("weights") is not None:
        raise ValueError("nmf2d_encode: weights= is not supported")
    B, m, n = Vs.shape
    dtype = Vs.dtype
    P = int(pitch_len)
    if P < 1 or P > m:
        raise ValueError(f"pitch_len must be in [1, {m}]; got {P}")
    W = as_tensor(W, dtype, src)
    if W.ndim != 3 or W.shape[0] != m:
        raise ValueError(f"dictionary W must be (m, k, T) with m = {m}; "
                         f"got {tuple(W.shape)}")
    k, T = W.shape[1], W.shape[2]
    maxiter, _, eps, gen = common_scalars(cfg)

    H0 = cfg.get("H_init")
    H0 = (uniform_init(gen, (B, k, n, P), dtype, src) if H0 is None
          else as_tensor(H0, dtype, src))
    if tuple(H0.shape) != (B, k, n, P):
        raise ValueError(f"H_init must be {(B, k, n, P)}; got {tuple(H0.shape)}")
    Vs, W, H0 = apply_placements(mesh, "nmf2d_encode", V=Vs, W=W, H=H0)
    # entry normalization with norm transfer into every problem's init
    # (models/nmf2d.py's convention, W_fixed included)
    W, norms = cross_frame_norm(W, None, T, return_norms=True)
    H0 = H0 * norms[None, :, None, None]
    hsp = torch.full((k,), max(float(cfg.get("H_sparsity") or 0.0), 0.0),
                     dtype=dtype, device=device)

    spec = _EncSpec(maxiter, eps, div, alpha, beta, parse_cost_every(cfg), P)
    H, costs = _gather(mesh, *_solve_nmf2d_encode(spec, Vs, W, H0, hsp))
    return _result(W, H, costs, maxiter)


class _CmfEncSpec(NamedTuple):
    iters: int
    eps: float
    blocks: tuple
    p_fixed: tuple


def _solve_cmf_encode(spec: _CmfEncSpec, Vs, W, H0, P0, hsp):
    """H/P-only complex MU of every problem against ONE real dictionary W
    (m, k), on device tensors, with no host sync.  Per problem it is
    ``cmfwisa(V_i, ks, W_init=[W_s], W_fixed=True)``: with W frozen the H
    denominator's (W_new' W) H is (W'W) H with a loop-invariant (k, k)
    Gram; the V_bar / beta / G fields (cmfwisa.m:177-188) are nonlinear in
    H and stay in the loop.  Returns (H, P, costs (B, iters))."""
    blocks, eps = spec.blocks, spec.eps
    WtW = W.T @ W

    def step(state):
        H, P, WH = state  # WH: the per-source reconstructions of H
        P, G, _ = phase_fields(Vs, WH, P, spec.p_fixed)
        M = WtW @ H  # cmfwisa.m:200 with W fixed
        H = torch.cat([H[:, a:b] * ((W[:, a:b].T @ G[:, s])
                                    / torch.clamp_min(M[:, a:b] + hsp[a:b, None], eps))
                       for s, (a, b) in enumerate(blocks)], dim=1)
        WH = per_source_wh(W, H, blocks)
        return (H, P, WH), lambda: complex_cost(Vs, WH, P, H, hsp)

    (H, P, _), costs = _scan(step, (H0, P0, per_source_wh(W, H0, blocks)),
                             spec.iters, 1, W.dtype)
    return H, P, costs


def cmfwisa_encode(Vs, W, config: dict | None = None, **kwargs):
    """Encode a complex batch Vs (B, m, n) against frozen magnitude
    dictionaries — phase-aware serving (King 2012's CMF with the W update
    disabled): per problem it fits the per-source encodings H and
    unit-modulus phases P with V_i ~ sum_s (W_s H_s) .* P_s.

    Per-problem trajectories are exactly ``cmfwisa(V_i, ks,
    W_init=[W_s], W_fixed=True)``, including the entry unit-L2 column
    normalization of W (cmfwisa.m:154) and the default phase init
    exp(1j angle(V_i)) (cmfwisa.m:119).  Vs is a complex (B, m, n) array
    or tensor, or a (V_re, V_im) pair of real (B, m, n) planes.

    Parameters: W — one (m, k) array or a LIST of per-source
    dictionaries; H_init (B, k, n) or a per-source list; P_init
    (B, S, m, n) complex or a per-source list of (B, m, n); P_fixed and
    H_sparsity (scalar or per source); maxiter (100); seed; dtype; eps;
    device, mesh (problems shard over its sample axis, as in
    :func:`nmf_encode`).  ``device_output`` changes nothing (P is a complex tensor on
    the device either way); ``divergence``, ``data_dtype``, ``weights``
    and the W options raise ``ValueError``.  Returns Result with W (m, k, normalized),
    H (B, k, n) and P (B, m, n) per source — per-source lists when W was
    a list — as tensors on the run's device, and cost (B, maxiter), NumPy.
    """
    cfg = merge_config(config, kwargs)
    for key, why in [
            ("divergence", "cmfwisa is complex-euclidean only (cmfwisa.m:214-217)"),
            ("data_dtype", "the complex fields read V at compute precision"),
            ("weights", "the complex objective has no weighted form here")]:
        if cfg.get(key) is not None:
            raise ValueError(f"cmfwisa_encode: {key!r} does not apply — {why}")
    _reject_encode_config(cfg, "cmfwisa_encode")
    planes = isinstance(Vs, tuple) and len(Vs) == 2  # (V_re, V_im)
    mesh, device, src, dtype = _ingest(Vs[0] if planes else Vs, cfg)
    if planes:
        rdt = real_dtype_of(dtype)
        V_re, V_im = (as_tensor(x, rdt, src) for x in Vs)
        if V_re.ndim != 3 or V_re.shape != V_im.shape:
            raise ValueError(f"cmfwisa_encode plane inputs must both be (B, m, n); "
                             f"got {tuple(V_re.shape)} and {tuple(V_im.shape)}")
        Vs = torch.complex(V_re, V_im)
    else:
        Vs = as_tensor(Vs, complex_dtype_of(dtype), src)
        if Vs.ndim != 3:
            raise ValueError(f"cmfwisa_encode expects Vs of shape (B, m, n) or a "
                             f"(V_re, V_im) plane pair; got {tuple(Vs.shape)} (encode "
                             "a single matrix with cmfwisa(V, ks, W_init=W, W_fixed=True))")
    cdt = Vs.dtype
    rdt = real_dtype_of(cdt)
    B, m, n = Vs.shape
    _check_batch_mesh(B, mesh, "cmfwisa_encode")
    w_list, w_was_seq = as_list(W)
    w_list = [as_tensor(w, rdt, src) for w in w_list]
    S = len(w_list)
    for s, w in enumerate(w_list):
        if w.ndim != 2 or w.shape[0] != m:
            raise ValueError(f"dictionary W[{s}] must be (m, k) = ({m}, k); "
                             f"got {tuple(w.shape)}")
    ks = [w.shape[1] for w in w_list]
    blocks = source_blocks(ks)
    W = torch.cat(w_list, dim=1)
    k = W.shape[1]
    maxiter, _, eps, gen = common_scalars(cfg)

    H0 = cfg.get("H_init")
    if H0 is None:
        H0 = uniform_init(gen, (B, k, n), rdt, src)
    elif isinstance(H0, (list, tuple)):
        if len(H0) != S:
            raise ValueError(f"Requested {S} sources. Given {len(H0)} "
                             "initial encoding matrices.")
        H0 = torch.cat([as_tensor(h, rdt, src) for h in H0], dim=1)
    H0 = as_tensor(H0, rdt, src)
    if tuple(H0.shape) != (B, k, n):
        raise ValueError(f"H_init must be {(B, k, n)}; got {tuple(H0.shape)}")
    P0 = cfg.get("P_init")
    if isinstance(P0, (list, tuple)):
        if len(P0) != S:
            raise ValueError(f"Requested {S} sources. Given {len(P0)} "
                             "initial phase matrices.")
        P0 = torch.stack([as_tensor(p, cdt, src) for p in P0], dim=1)
    if P0 is not None:
        P0 = as_tensor(P0, cdt, src)
        if tuple(P0.shape) != (B, S, m, n):
            raise ValueError(f"P_init must be {(B, S, m, n)} (or a list of S (B, m, n) "
                             f"per-source arrays); got {tuple(P0.shape)}")
    p_fx = tuple(bool(x) for x in
                 promote_per_source(cfg.get("P_fixed"), S, "P_fixed", False))
    h_sp = [max(float(v), 0.0) for v in
            promote_per_source(cfg.get("H_sparsity"), S, "H_sparsity", 0.0)]
    hsp = per_column(h_sp, ks, rdt, device)

    Vs, W, H0 = apply_placements(mesh, "cmfwisa_encode", V=Vs, W=W, H=H0)
    W = unit_l2_columns(W)  # cmfwisa.m:154
    if P0 is None:
        P0 = unit_phase(Vs)[:, None].expand(Vs.shape[0], S, m, n)  # cmfwisa.m:119 per problem
    else:
        P0 = apply_placements(mesh, "cmfwisa_encode", P=P0)
    H, P, costs = _gather(mesh, *_solve_cmf_encode(_CmfEncSpec(maxiter, eps, blocks, p_fx),
                                                   Vs, W, H0, P0, hsp))
    return Result(fields=("W", "H", "P", "cost"),
                  W=unwrap_sources(W, blocks, 1, w_was_seq),
                  H=unwrap_sources(H, blocks, 1, w_was_seq),
                  P=[P[:, s] for s in range(S)] if w_was_seq else P[:, 0],
                  cost=costs.cpu().numpy(), n_iters=maxiter, converged=False)
