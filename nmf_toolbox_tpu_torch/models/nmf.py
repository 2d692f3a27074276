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
                    parse_cost_every, per_column, promote_inits,
                    promote_per_source, resolve_device, resolve_dtype,
                    source_blocks, span, staging_device, torch_dtype,
                    unwrap_sources)
from ..ops import divergence as dv
from ..ops import loop as looplib
from ..ops.gram import euclidean_cost_gram, sq_norm, vdot
from ..ops.masking import region_mask
from ..ops.normalize import unit_l2_columns, unit_l2_columns_entry
from ..parallel.collectives import gather_factor, sum_all, sum_features, sum_samples
from ..parallel.mesh import apply_placements, check_mesh
from ..parallel.padding import pad_axes, plan_padding, prepare_weights
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
    valid: tuple = None  # (m, n) true sizes of a mesh-padded problem
    sparse: tuple = (False, False)  # any W / H sparsity penalty


def _make_step(spec: _Spec, V, wsp, hsp, Mw=None, mesh=None):
    """The ``run`` step function (state, i) -> (state, cost, terminate).

    Under a ``mesh``, V, W, H and the weights are this rank's blocks
    (``parallel.placements_for("nmf")``): every product runs on the local
    block, the fused kernels included, and the cross-shard sums go
    through ``parallel/collectives.py`` -- over samples for V H', H H',
    the W-phase kernel and H's row sums, over features for W'V, W'W, the
    H-phase kernel and W's column sums, over every rank for a cost.  The
    cost every rank returns is the reduced one, so every rank's stop rule
    takes the same decision."""
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
    kl = div == "kl"
    if spec.method == "gram":
        fdt = wsp.dtype  # the factors' dtype
        v_sq = sum_all(mesh, sq_norm(V.to(fdt)))
    elif spec.method == "naive":
        # the valid region of a padded problem, from this block's offsets
        offset = ((0, 0) if mesh is None else
                  (mesh.coord("m") * V.shape[0], mesh.coord("n") * V.shape[1]))
        mask = region_mask(V.shape, spec.valid, V.device, offset)
    else:
        from ..ops.kernels import fused as fk
        V = V.contiguous()  # the kernels take row-major operands
        # Field-independent cost constants of this block, computed once;
        # the cost sums them over the ranks with the fields' terms, so
        # the m * n of IS counts the global sizes.
        if kl:
            c_const = torch.sum(V * torch.log(V)) - torch.sum(V)  # nmf.m:210
        else:
            c_const = -torch.sum(torch.log(V)) - V.numel()       # nmf.m:212

    def penalty(W, H):
        """Per-source L1 penalties added to the cost (nmf.m:216-218)."""
        pw = torch.sum(wsp * torch.sum(torch.abs(W), dim=0))
        ph = torch.sum(hsp * torch.sum(torch.abs(H), dim=1))
        if mesh is not None:
            pw = sum_features(mesh, pw) if spec.sparse[0] else pw
            ph = sum_samples(mesh, ph) if spec.sparse[1] else ph
        return pw + ph

    def update_w(W, neg, pos):
        Wn = W * (neg / torch.clamp_min(pos + wsp[None, :], eps))
        Wn = unit_l2_columns(Wn, mesh)
        return Wn if w_all_free else torch.where(w_mask[None, :], W, Wn)

    def update_h(H, neg, pos):
        Hn = H * (neg / torch.clamp_min(pos + hsp[:, None], eps))
        return Hn if h_all_free else torch.where(h_mask[:, None], H, Hn)

    def gram_step(carry, i):
        W, H = carry[0], carry[1]
        if w_any:
            HHt, VHt = sum_samples(mesh, H @ H.T, vdot(V, H.T, V.dtype))  # [mnk]
            # Accelerated MU (Gillis & Glineur 2012, arXiv:1107.5194):
            # VHt and HHt depend only on V and the fixed H, so the W step
            # can repeat `inner` times reusing them.  inner=1 is the
            # reference trajectory.
            for _ in range(spec.inner):
                WG = W @ HHt                       # = V_hat @ H'
                dneg, dpos = sum_features(
                    mesh, torch.sum(W * WG, dim=0),  # diag(Hs V_hat' Ws)
                    torch.sum(W * VHt, dim=0))       # diag(Hs V' Ws)
                W = update_w(W, VHt + W * dneg[None, :], WG + W * dpos[None, :])
        WtV, WtW = sum_features(mesh, vdot(W.T, V, V.dtype), W.T @ W)  # [mnk]
        if h_any:
            for _ in range(spec.inner):
                H = update_h(H, WtV, WtW @ H)

        def cost_fn():
            c = euclidean_cost_gram(v_sq, WtV, WtW, H, mesh=mesh)
            return c + penalty(W, H)
        return finish((W, H), carry, i, cost_fn)

    def naive_step(carry, i):
        W, H = carry[0], carry[1]
        V_hat = W @ H
        if w_any:
            phi_neg, phi_pos, power = dv.fields(div, V, V_hat, alpha, beta,
                                                mask=mask, weights=Mw)
            if phi_pos is None:  # ones(m, n) @ H' without the ones (nmf.m:153)
                A, h_rowsum = sum_samples(mesh, phi_neg @ H.T, torch.sum(H, dim=1))
                B = h_rowsum[None, :].expand(W.shape)
            else:
                A, B = sum_samples(mesh, phi_neg @ H.T, phi_pos @ H.T)
            dneg, dpos = sum_features(mesh, torch.sum(W * B, dim=0),
                                      torch.sum(W * A, dim=0))
            neg = dv.apply_power(A + W * dneg[None, :], power)
            pos = dv.apply_power(B + W * dpos[None, :], power)
            W = update_w(W, neg, pos)
            V_hat = W @ H
        if h_any:
            phi_neg, phi_pos, power = dv.fields(div, V, V_hat, alpha, beta,
                                                mask=mask, weights=Mw)
            if phi_pos is None:  # W' @ ones(m, n) without the ones (nmf.m:184)
                neg, w_colsum = sum_features(mesh, W.T @ phi_neg, torch.sum(W, dim=0))
                pos = w_colsum[:, None].expand(H.shape)
            else:
                neg, pos = sum_features(mesh, W.T @ phi_neg, W.T @ phi_pos)
            H = update_h(H, dv.apply_power(neg, power), dv.apply_power(pos, power))

        def cost_fn():
            c = dv.cost(div, V, W @ H, alpha, beta, mask=mask, weights=Mw,
                        mesh=mesh)
            return c + penalty(W, H)
        return finish((W, H), carry, i, cost_fn)

    def fused_step(carry, i):
        W, H = carry[0], carry[1]
        if w_any:
            if kl:
                A, h_rowsum = sum_samples(mesh, fk.phi_dot_ht(V, W, H, "kl"),
                                          torch.sum(H, dim=1))
                w_colsum, dpos = sum_features(mesh, torch.sum(W, dim=0),
                                              torch.sum(W * A, dim=0))
                dneg = w_colsum * h_rowsum
                neg = A + W * dneg[None, :]
                pos = h_rowsum[None, :] + W * dpos[None, :]
            else:
                A, B = sum_samples(mesh, *fk.phi_dot_ht(V, W, H, "is"))
                dneg, dpos = sum_features(mesh, torch.sum(W * B, dim=0),
                                          torch.sum(W * A, dim=0))
                neg = A + W * dneg[None, :]
                pos = B + W * dpos[None, :]
            W = update_w(W, neg, pos)
        if h_any:
            if kl:
                neg, w_colsum = sum_features(mesh, fk.wt_dot_phi(V, W, H, "kl"),
                                             torch.sum(W, dim=0))
                pos = w_colsum[:, None]
            else:
                neg, pos = sum_features(mesh, *fk.wt_dot_phi(V, W, H, "is"))
            H = update_h(H, neg, pos)

        def cost_fn():
            # Every term is a sum over this block's entries (sum(V_hat) =
            # sum(W) @ sum(H) block by block), so one sum over the ranks
            # gives the whole cost.
            if kl:
                s = fk.cost_terms(V, W, H, "kl")
                sum_vhat = torch.sum(W, dim=0) @ torch.sum(H, dim=1)
                c = c_const - s + sum_vhat
            else:
                s1, s2 = fk.cost_terms(V, W, H, "is")
                c = c_const + s1 + s2
            return sum_all(mesh, c) + penalty(W, H)
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
    ``V`` runs on its own device.  ``callback``: called as
    ``callback(i, cost)`` after every iteration, with the carried cost on
    the iterations ``cost_every`` skips (see ``ops/loop.run``); the run
    then reads the device once per iteration.

    ``mesh`` (``parallel.make_mesh``): every rank of the mesh calls
    ``nmf`` with the same arguments; V (a host array, or a tensor) is
    zero-padded to the mesh's multiples and each rank copies only its
    block to its device (``parallel.placements_for("nmf")``), runs the
    step on it with explicit reductions, and returns the whole W and H,
    gathered, on its device.  ``method='fused'`` refuses a shape that
    needs padding, as in the JAX package.

    Returns a :class:`Result` unpacking as (W, H, cost): ``W`` and ``H``
    tensors on the run's device, ``cost`` a NumPy array.

    Under a profiler the call is the span ``nmf.solve``: its entry work
    (config, inits, placement, W0's unit columns, the step's constants)
    runs from its start to the loop's span ``loop.run``.
    """
    with span("nmf.solve"):
        return _solve(V, num_basis_elems, config, kwargs)


def _solve(V, num_basis_elems, config, kwargs):
    cfg = merge_config(config, kwargs)
    mesh = check_mesh(cfg.get("mesh"))
    device = resolve_device(V, cfg.get("device"), mesh)
    dtype = resolve_dtype(V, cfg.get("dtype"))
    src = staging_device(V, device, mesh)  # the whole arrays until placement
    V = as_tensor(V, dtype, src)
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
        # ROADMAP queue 1 item 1 says otherwise.
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
        # The seeding reads the whole V on the run's device, so under a
        # mesh too the whole arrays stay there and placement cuts them.
        src = device
        V = V.to(src)
        Vs = seedable(V) if weights is not None else V
        Wn, Hn = nndsvd(Vs.to(cdt), ks[0], generator=gen, variant=init)
        # The solver normalizes W columns to unit L2 (nmf.m:132-134);
        # transfer the norms into H first so W @ H is preserved.
        norms = torch.sqrt(torch.clamp_min(torch.sum(Wn * Wn, dim=0), eps))
        w_list = [(Wn / norms[None, :]).to(dtype)]
        h_list = [(Hn * norms[:, None]).to(dtype)]
        w_was_seq = h_was_seq = was_seq
    if w_list is None:
        w_list = default_w_init(gen, m, ks, dtype, src)
        w_was_seq = was_seq
    if h_list is None:
        h_list = default_h_init(gen, ks, n, dtype, src)
        h_was_seq = was_seq
    for s, (w, h, k) in enumerate(zip(w_list, h_list, ks)):
        if tuple(w.shape) != (m, k):
            raise ValueError(f"W_init[{s}] has shape {tuple(w.shape)}, expected {(m, k)}")
        if tuple(h.shape) != (k, n):
            raise ValueError(f"H_init[{s}] has shape {tuple(h.shape)}, expected {(k, n)}")

    W0 = torch.cat([as_tensor(w, dtype, src) for w in w_list], dim=1)
    H0 = torch.cat([as_tensor(h, dtype, src) for h in h_list], dim=0)

    wsp = per_column(w_sp, ks, dtype, device)
    hsp = per_column(h_sp, ks, dtype, device)
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

    pad_m, pad_n, valid = plan_padding(mesh, m, n)
    if valid is not None:
        if method == "fused":
            raise ValueError(
                "method='fused' does not support mesh shapes that need "
                "padding; use a divisible (m, n) or method='naive'")
        V = pad_axes(V, {0: pad_m, 1: pad_n})
        W0 = pad_axes(W0, {0: pad_m})
        H0 = pad_axes(H0, {1: pad_n})
    V, W0, H0 = apply_placements(mesh, "nmf", V=V, W=W0, H=H0)
    weights = prepare_weights(weights, dtype, (m, n), mesh, "nmf",
                              pad_m, pad_n, valid, device=device)
    # Unit-L2 column normalization of the (possibly user-supplied) init
    # (nmf.m:132-134); columns already normalized to rounding stay as
    # they are, so a chunked run continues bit for bit.
    W0 = unit_l2_columns_entry(W0, mesh)

    ce = parse_cost_every(cfg)
    spec = _Spec(div, alpha, beta, method, maxiter, w_fx, h_fx, blocks, eps,
                 inner, ce, valid, (any(w_sp), any(h_sp)))
    with torch.no_grad():
        step = _make_step(spec, V, wsp, hsp, weights, mesh)
        out = looplib.run(step, looplib.cadence_state((W0, H0), ce, dtype),
                          maxiter, tolerance, cost_dtype=dtype,
                          cost_every=ce, callback=cfg.get("callback"))

    W = gather_factor(mesh, out.state[0], "m", 0)
    H = gather_factor(mesh, out.state[1], "n", 1)
    if valid is not None:
        W, H = W[:m], H[:, :n]
    return Result(
        fields=("W", "H", "cost"),
        W=unwrap_sources(W, blocks, 1, w_was_seq),
        H=unwrap_sources(H, blocks, 0, h_was_seq),
        cost=looplib.trim_cost(out, maxiter),
        n_iters=out.n_iters,
        converged=out.stopped,
    )
