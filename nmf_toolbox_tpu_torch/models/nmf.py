"""NMF with multiplicative updates over four divergences.

PyTorch counterpart of ``nmf_toolbox_tpu/models/nmf.py`` (reference:
nmf.m), with the same config surface, guards and results:

* Multi-source "cell arrays" (nmf.m:114-117) become static column blocks
  of one concatenated (m, k_total) basis.
* ``method='gram'`` (Euclidean) never materializes the m-by-n
  reconstruction: two full-size matmuls per iteration (V @ H' and W' @ V)
  and k-by-k Grams for the rest, cost included.  With
  ``data_dtype='bfloat16'`` V is stored in bf16 and both products take
  bf16 inputs and accumulate in f32.
* ``method='naive'`` (any divergence, and the only one taking
  ``weights``) builds the reconstruction; the KL ones-field stays
  implicit (nmf.m:152-153).
* ``method='fused'`` (KL/IS, f32) runs the hand-written kernels of
  ``ops/kernels/fused.py``, so neither the reconstruction nor the ratio
  fields reach device memory.

The iteration loop is ``ops/loop.run``: eager steps, with the stop rule
read on the host once per check iteration.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import (Result, as_list, as_tensor, common_scalars, default_h_init,
                    default_w_init, fixed_col_mask, merge_config,
                    parse_cost_every, per_column, prepare_weights,
                    promote_inits, promote_per_source, resolve_device,
                    resolve_dtype, source_blocks, torch_dtype, unwrap_sources)
from ..ops import divergence as dv
from ..ops import loop as looplib
from ..ops.gram import euclidean_cost_gram, sq_norm
from ..ops.normalize import unit_l2_columns
from ..utils.init import nndsvd, seedable


class _Spec(NamedTuple):
    divergence: str
    alpha: float
    beta: float
    method: str          # 'gram' | 'naive' | 'fused'
    maxiter: int
    w_fixed: tuple
    h_fixed: tuple
    blocks: tuple
    eps: float
    inner: int = 1       # accelerated-MU inner repetitions (gram only)
    cost_every: int = 1  # objective cadence (1 = reference semantics)


def _kl_ones_b(H, m):
    """ones(m, n) @ H' without the m-by-n ones matrix (nmf.m:153)."""
    return torch.sum(H, dim=1)[None, :].expand(m, H.shape[0])


def _kl_ones_pos_h(W, n):
    """W' @ ones(m, n) without the ones matrix (nmf.m:184)."""
    return torch.sum(W, dim=0)[:, None].expand(W.shape[1], n)


def _sparsity_penalty(W, H, wsp, hsp):
    """Per-source L1 penalties added to the cost (nmf.m:216-218)."""
    return (torch.sum(wsp * torch.sum(torch.abs(W), dim=0))
            + torch.sum(hsp * torch.sum(torch.abs(H), dim=1)))


def _make_step(spec: _Spec, V, wsp, hsp, Mw=None):
    """The ``run`` step function (state, i) -> (state, cost, terminate)."""
    div, alpha, beta, eps = spec.divergence, spec.alpha, spec.beta, spec.eps
    w_any = not all(spec.w_fixed)
    h_any = not all(spec.h_fixed)
    ks = [b - a for a, b in spec.blocks]
    w_mask = torch.as_tensor(fixed_col_mask(spec.w_fixed, ks), device=V.device)
    h_mask = torch.as_tensor(fixed_col_mask(spec.h_fixed, ks), device=V.device)
    w_all_free = not any(spec.w_fixed)
    h_all_free = not any(spec.h_fixed)
    # ``cost_every`` tail: evaluate the objective only on check
    # iterations, carrying the last value in between.
    finish = looplib.cost_cadence(spec.cost_every, spec.maxiter)
    m, n = V.shape
    kl = div == "kl"
    if spec.method == "gram":
        fdt = wsp.dtype  # the factors' dtype
        v_sq = sq_norm(V.to(fdt))

        def vdot(A, B):
            """A @ B with V (one of them) in its storage dtype: a bf16 or
            f16 V takes low-precision inputs and accumulates in f32."""
            A, B = A.to(V.dtype), B.to(V.dtype)
            if V.dtype.itemsize >= 4:
                return A @ B
            if V.is_cuda:
                return torch.mm(A, B, out_dtype=torch.float32)
            # The CPU build has no out_dtype overload: upcast the
            # low-precision operands (exact) and multiply in f32.
            return A.float() @ B.float()
    elif spec.method == "fused":
        from ..ops.kernels import fused as fk
        V = V.contiguous()  # the kernels take row-major operands
        # Field-independent cost constants, computed once.
        if kl:
            c_const = torch.sum(V * torch.log(V)) - torch.sum(V)  # nmf.m:210
        else:
            c_const = -torch.sum(torch.log(V)) - m * n           # nmf.m:212

    def update_w(W, neg, pos):
        Wn = W * (neg / torch.clamp_min(pos + wsp[None, :], eps))
        Wn = unit_l2_columns(Wn)
        return Wn if w_all_free else torch.where(w_mask[None, :], W, Wn)

    def update_h(H, neg, pos):
        Hn = H * (neg / torch.clamp_min(pos + hsp[:, None], eps))
        return Hn if h_all_free else torch.where(h_mask[:, None], H, Hn)

    def gram_step(carry, i):
        W, H = carry[0], carry[1]
        if w_any:
            HHt = H @ H.T
            VHt = vdot(V, H.T)                     # [mnk]
            # Accelerated MU (Gillis & Glineur 2012, arXiv:1107.5194):
            # VHt and HHt depend only on V and the fixed H, so the W step
            # can repeat `inner` times reusing them.  inner=1 is the
            # reference trajectory.
            for _ in range(spec.inner):
                WG = W @ HHt                       # = V_hat @ H'
                dneg = torch.sum(W * WG, dim=0)    # diag(Hs V_hat' Ws)
                dpos = torch.sum(W * VHt, dim=0)   # diag(Hs V' Ws)
                W = update_w(W, VHt + W * dneg[None, :], WG + W * dpos[None, :])
        WtV = vdot(W.T, V)                         # [mnk]
        WtW = W.T @ W
        if h_any:
            for _ in range(spec.inner):
                H = update_h(H, WtV, WtW @ H)

        def cost_fn():
            c = euclidean_cost_gram(v_sq, WtV, WtW, H)
            return c + _sparsity_penalty(W, H, wsp, hsp)
        return finish((W, H), carry, i, cost_fn)

    def naive_step(carry, i):
        W, H = carry[0], carry[1]
        V_hat = W @ H
        if w_any:
            phi_neg, phi_pos, power = dv.fields(div, V, V_hat, alpha, beta,
                                                weights=Mw)
            A = phi_neg @ H.T
            B = _kl_ones_b(H, m) if phi_pos is None else phi_pos @ H.T
            dneg = torch.sum(W * B, dim=0)
            dpos = torch.sum(W * A, dim=0)
            neg = dv.apply_power(A + W * dneg[None, :], power)
            pos = dv.apply_power(B + W * dpos[None, :], power)
            W = update_w(W, neg, pos)
            V_hat = W @ H
        if h_any:
            phi_neg, phi_pos, power = dv.fields(div, V, V_hat, alpha, beta,
                                                weights=Mw)
            neg = dv.apply_power(W.T @ phi_neg, power)
            pos = _kl_ones_pos_h(W, n) if phi_pos is None else W.T @ phi_pos
            H = update_h(H, neg, dv.apply_power(pos, power))

        def cost_fn():
            c = dv.cost(div, V, W @ H, alpha, beta, weights=Mw)
            return c + _sparsity_penalty(W, H, wsp, hsp)
        return finish((W, H), carry, i, cost_fn)

    def fused_step(carry, i):
        W, H = carry[0], carry[1]
        if w_any:
            if kl:
                A = fk.phi_dot_ht(V, W, H, "kl")
                h_rowsum = torch.sum(H, dim=1)
                dneg = torch.sum(W, dim=0) * h_rowsum
                dpos = torch.sum(W * A, dim=0)
                neg = A + W * dneg[None, :]
                pos = h_rowsum[None, :] + W * dpos[None, :]
            else:
                A, B = fk.phi_dot_ht(V, W, H, "is")
                dneg = torch.sum(W * B, dim=0)
                dpos = torch.sum(W * A, dim=0)
                neg = A + W * dneg[None, :]
                pos = B + W * dpos[None, :]
            W = update_w(W, neg, pos)
        if h_any:
            if kl:
                neg = fk.wt_dot_phi(V, W, H, "kl")
                pos = torch.sum(W, dim=0)[:, None]
            else:
                neg, pos = fk.wt_dot_phi(V, W, H, "is")
            H = update_h(H, neg, pos)

        def cost_fn():
            if kl:
                s = fk.cost_terms(V, W, H, "kl")
                sum_vhat = torch.sum(W, dim=0) @ torch.sum(H, dim=1)
                c = c_const - s + sum_vhat
            else:
                s1, s2 = fk.cost_terms(V, W, H, "is")
                c = c_const + s1 + s2
            return c + _sparsity_penalty(W, H, wsp, hsp)
        return finish((W, H), carry, i, cost_fn)

    return {"gram": gram_step, "naive": naive_step,
            "fused": fused_step}[spec.method]


def nmf(V, num_basis_elems, config: dict | None = None, **kwargs):
    """Decompose a non-negative matrix V ~ W @ H.

    Parameter surface mirrors ``nmf_toolbox_tpu.nmf`` (reference
    nmf.m:17-65): ``divergence`` ('euclidean' | 'kl' | 'is' | 'ab' +
    aliases), ``alpha``/``beta`` (AB only), ``W_init``/``H_init`` (array,
    tensor or per-source list), ``W_sparsity``/``H_sparsity``,
    ``W_fixed``/``H_fixed``, ``maxiter`` (100), ``tolerance`` (1e-3).
    Extras: ``dtype``, ``seed``, ``method`` ('auto' | 'gram' | 'naive' |
    'fused'), ``eps``, ``inner_iters`` (accelerated MU, Euclidean Gram
    path), ``weights`` ((m, n) nonnegative per-entry weights, naive path),
    ``cost_every`` (objective cadence: the factor trajectory is identical
    at any value; the stop rule becomes "decrease over the last N
    iterations < tolerance").

    ``init`` ('random' | 'nndsvd' | 'nndsvda' | 'nndsvdar': SVD-seeded
    factors, single source, not with ``W_init``/``H_init``) and
    ``data_dtype`` (e.g. 'bfloat16': V's storage dtype on the Gram path).

    ``device``: where a NumPy ``V`` goes (default: the CUDA card; with no
    card the call raises, so pass ``"cpu"`` to run on the CPU); a tensor
    ``V`` runs on its own device.  ``callback`` and ``mesh`` are not
    ported yet and raise ``NotImplementedError``.

    Returns a :class:`Result` unpacking as (W, H, cost): ``W`` and ``H``
    tensors on the run's device, ``cost`` a NumPy array.
    """
    cfg = merge_config(config, kwargs)
    for key, item in (("callback", "queue 1 item 2"),
                      ("mesh", "queue 1 item 13 (multi-GPU)")):
        if cfg.get(key) is not None:
            raise NotImplementedError(
                f"{key}= is not ported to nmf_toolbox_tpu_torch yet "
                f"(ROADMAP {item})")
    device = resolve_device(V, cfg.get("device"))
    dtype = resolve_dtype(V, cfg.get("dtype"))
    V = as_tensor(V, dtype, device)
    m, n = V.shape

    ks, was_seq = as_list(num_basis_elems)
    ks = [int(k) for k in ks]
    S = len(ks)
    blocks = source_blocks(ks)

    div = dv.canon(cfg.get("divergence", "euclidean"))
    if div == "ab":
        alpha = float(cfg.get("alpha", 1.0))
        beta = float(cfg.get("beta", 1.0))
        if alpha == 0.0 and beta == 0.0:
            raise ValueError("alpha = 0 and beta = 0 is not supported at this time.")
    else:
        alpha, beta = 1.0, 1.0  # forced outside AB (nmf.m:255-266)

    method = cfg.get("method", "auto")
    k_total = sum(ks)
    weights = cfg.get("weights")
    if weights is not None:
        # The weighted fields need the full reconstruction, so only the
        # naive path applies.
        if method == "auto":
            method = "naive"
        elif method != "naive":
            raise ValueError("weights= requires method='naive' (the "
                             "weighted fields are nonlinear in W @ H)")
    if method == "auto":
        # The JAX package's choice, kept until the H100 measurement of
        # ROADMAP queue 1 item 3 says otherwise.
        method = "gram" if div == "euclidean" else "naive"
    if method not in ("gram", "naive", "fused"):
        raise ValueError(f"unknown method {method!r}; expected 'auto', "
                         "'gram', 'naive' or 'fused'")
    if method == "gram" and div != "euclidean":
        raise ValueError("method='gram' is only valid for the euclidean divergence")
    if method == "fused":
        if div not in ("kl", "is"):
            raise ValueError("method='fused' is only valid for kl/is divergences")
        if dtype != torch.float32:
            raise ValueError("method='fused' requires float32")
        if k_total > 1024:
            raise ValueError("method='fused' supports k <= 1024; use "
                             "method='naive'")

    w_sp = promote_per_source(cfg.get("W_sparsity"), S, "W_sparsity", 0.0)
    h_sp = promote_per_source(cfg.get("H_sparsity"), S, "H_sparsity", 0.0)
    w_sp = [max(float(v), 0.0) for v in w_sp]
    h_sp = [max(float(v), 0.0) for v in h_sp]
    w_fx = tuple(bool(b) for b in promote_per_source(cfg.get("W_fixed"), S, "W_fixed", False))
    h_fx = tuple(bool(b) for b in promote_per_source(cfg.get("H_fixed"), S, "H_fixed", False))
    maxiter, tolerance, eps, gen = common_scalars(cfg)

    w_list, w_was_seq = promote_inits(cfg.get("W_init"), S, "basis")
    h_list, h_was_seq = promote_inits(cfg.get("H_init"), S, "encoding")
    init = str(cfg.get("init", "random"))
    if init != "random":
        if init not in ("nndsvd", "nndsvda", "nndsvdar"):
            raise ValueError(f"unknown init {init!r}; expected 'random', "
                             "'nndsvd', 'nndsvda', or 'nndsvdar'")
        if w_list is not None or h_list is not None:
            raise ValueError("init='nndsvd*' cannot be combined with "
                             "W_init/H_init")
        if S != 1:
            raise ValueError("init='nndsvd*' supports a single source")
        cdt = torch.promote_types(dtype, torch.float32)
        Vs = seedable(V) if weights is not None else V
        Wn, Hn = nndsvd(Vs.to(cdt), ks[0], generator=gen, variant=init)
        # The solver normalizes W columns to unit L2 (nmf.m:132-134);
        # transfer the norms into H first so W @ H is preserved.
        norms = torch.sqrt(torch.clamp_min(torch.sum(Wn * Wn, dim=0), eps))
        w_list = [(Wn / norms[None, :]).to(dtype)]
        h_list = [(Hn * norms[:, None]).to(dtype)]
        w_was_seq = h_was_seq = was_seq
    if w_list is None:
        w_list = default_w_init(gen, m, ks, dtype, device)
        w_was_seq = was_seq
    if h_list is None:
        h_list = default_h_init(gen, ks, n, dtype, device)
        h_was_seq = was_seq
    for s, (w, h, k) in enumerate(zip(w_list, h_list, ks)):
        if tuple(w.shape) != (m, k):
            raise ValueError(f"W_init[{s}] has shape {tuple(w.shape)}, expected {(m, k)}")
        if tuple(h.shape) != (k, n):
            raise ValueError(f"H_init[{s}] has shape {tuple(h.shape)}, expected {(k, n)}")

    W0 = torch.cat([as_tensor(w, dtype, device) for w in w_list], dim=1)
    H0 = torch.cat([as_tensor(h, dtype, device) for h in h_list], dim=0)
    # Unit-L2 column normalization of the (possibly user-supplied) init
    # (nmf.m:132-134).
    W0 = unit_l2_columns(W0)

    wsp = per_column(w_sp, ks, dtype, device)
    hsp = per_column(h_sp, ks, dtype, device)
    if weights is not None:
        weights = prepare_weights(weights, dtype, device, (m, n))
    data_dtype = cfg.get("data_dtype")
    if data_dtype is not None:
        if method != "gram":
            raise ValueError("data_dtype is only supported with the "
                             "euclidean Gram method")
        V = V.to(torch_dtype(data_dtype))

    inner = cfg.get("inner_iters", 1)
    inner = 1 if inner is None else int(inner)
    if inner < 1:
        raise ValueError("inner_iters must be >= 1")
    if inner > 1 and method != "gram":
        raise ValueError(
            "inner_iters > 1 (accelerated MU) requires the euclidean Gram "
            "method: the KL/IS/AB fields are nonlinear in W @ H, so inner "
            "repetitions would still need the full-size reconstruction")

    ce = parse_cost_every(cfg)
    spec = _Spec(div, alpha, beta, method, maxiter, w_fx, h_fx, blocks, eps,
                 inner, ce)
    with torch.no_grad():
        step = _make_step(spec, V, wsp, hsp, weights)
        out = looplib.run(step, looplib.cadence_state((W0, H0), ce, dtype),
                          maxiter, tolerance, cost_dtype=dtype,
                          cost_every=ce)

    W, H = out.state[0], out.state[1]
    return Result(
        fields=("W", "H", "cost"),
        W=unwrap_sources(W, blocks, 1, w_was_seq),
        H=unwrap_sources(H, blocks, 0, h_was_seq),
        cost=looplib.trim_cost(out, maxiter),
        n_iters=out.n_iters,
        converged=out.stopped,
    )
