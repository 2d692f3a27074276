"""Out-of-core NMF: V streamed from the host in column blocks.

PyTorch counterpart of ``nmf_toolbox_tpu/models/streaming.py``.  Where n
outgrows device memory, ``nmf_streaming`` factorizes V block by block
with online Euclidean multiplicative updates (after Lefèvre, Bach &
Févotte 2011):

    per block V_b:  H_b  <- a few MU encodings of V_b against the current W
                    A    <- rho A + V_b H_b'      (k-rank sufficient stats)
                    B    <- rho B + H_b H_b'
                    W    <- W * (A / max(W B, eps)),  unit-L2 columns

and ``nmf_encode_streaming`` encodes a wide V against a fixed W exactly,
block by block.  V is anything with ``V.shape`` and ``V[:, a:b]``: a
NumPy array or an ``np.load(..., mmap_mode="r")`` memmap.  Only (m,
block) slices reach the device.  A block of a row-major host V is a
strided gather; it is staged in one of two pinned buffers and copied
asynchronously, each buffer reused only after its last copy's event.

``nmf_streaming(mesh=)`` shards every block as nmf shards V: the block
is zero-padded to the mesh's multiples and each rank gathers on the host
only its own rows and columns of it; W and the statistic A follow the
features, B is replicated, and the statistics and costs sum over the
mesh (``parallel/collectives.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import (Result, as_tensor, common_scalars, merge_config,
                    resolve_device, resolve_dtype, staging_device, uniform_init)
from ..ops.normalize import unit_l2_columns
from ..parallel.collectives import gather_factor, sum_all, sum_features, sum_samples
from ..parallel.mesh import block_offset, check_mesh, shard
from ..parallel.padding import mesh_multiples, pad_amount, pad_axes

_NUMPY_STAGED = (torch.float16, torch.float32, torch.float64)


class _Blocks:
    """Column blocks ``V[:, a:b]`` of a host V as tensors on ``device``,
    or a rank's part of them (``rows``, ``shape``).

    On a CUDA device each block is gathered into one of two pinned host
    buffers and copied with ``non_blocking=True``; a CUDA event recorded
    after each copy is waited on before that buffer is written again, so
    the host never overwrites a buffer whose copy is in flight.  On the
    CPU a block is a plain copy.  A tensor V is sliced where it lies."""

    def __init__(self, V, block: int, dtype, device, size: int | None = None):
        self.V, self.dtype, self.device = V, dtype, device
        self.pinned = device.type == "cuda" and not torch.is_tensor(V)
        if self.pinned:
            # numpy fills the buffers; a dtype it cannot name goes as f32
            self.stage = dtype if dtype in _NUMPY_STAGED else torch.float32
            size = V.shape[0] * block if size is None else size
            self.bufs = [torch.empty(size, dtype=self.stage, pin_memory=True)
                         for _ in range(2)]
            self.events = [None, None]
            self.turn = 0

    def get(self, a: int, b: int, rows=None, shape=None):
        """V[rows, a:b] on the device (rows: a (start, stop) pair, default
        all), zero-padded at the end to ``shape`` when given."""
        r = slice(None) if rows is None else slice(*rows)
        if torch.is_tensor(self.V):
            part = self.V[r, a:b].to(device=self.device, dtype=self.dtype)
            if shape is None:
                return part
            return pad_axes(part, {0: shape[0] - part.shape[0], 1: shape[1] - part.shape[1]})
        part = self.V[r, a:b]
        shape = part.shape if shape is None else tuple(shape)
        if not self.pinned:
            out = np.zeros(shape, dtype=np.asarray(part[:0, :0]).dtype)
            out[:part.shape[0], :part.shape[1]] = part
            return torch.as_tensor(out, device=self.device).to(self.dtype)
        i, self.turn = self.turn, 1 - self.turn
        if self.events[i] is not None:
            self.events[i].synchronize()
        buf = self.bufs[i][: shape[0] * shape[1]].view(shape)
        if shape != part.shape:
            buf.zero_()
        np.copyto(buf.numpy()[:part.shape[0], :part.shape[1]], part, casting="unsafe")
        out = buf.to(self.device, non_blocking=True)
        self.events[i] = torch.cuda.Event()
        self.events[i].record()
        return out.to(self.dtype)


def _encode(Vb, W, Hb, inner: int, eps: float, mesh=None):
    """A few MU encodings of a block against a fixed basis."""
    WtV, WtW = sum_features(mesh, W.T @ Vb, W.T @ W)
    for _ in range(inner):
        Hb = Hb * (WtV / torch.clamp_min(WtW @ Hb, eps))
    return Hb


def _stats(Vb, Hb, mesh=None):
    VHt, HHt = sum_samples(mesh, Vb @ Hb.T, Hb @ Hb.T)
    return VHt, HHt, sum_all(mesh, torch.sum(Vb * Vb))


def _update_w(W, A, B, eps: float, mesh=None):
    return unit_l2_columns(W * (A / torch.clamp_min(W @ B, eps)), mesh)


def _block_cost(v_sq, Vb, W, Hb, mesh=None):
    WtV, WtW = sum_features(mesh, W.T @ Vb, W.T @ W)
    lin, sq = sum_samples(mesh, torch.sum(WtV * Hb), torch.sum((WtW @ Hb) * Hb))
    c = 0.5 * (v_sq - 2.0 * lin + sq)
    return torch.clamp_min(c, 0.0)


def nmf_streaming(V, num_basis_elems: int, config: dict | None = None,
                  **kwargs):
    """Online Euclidean NMF over column blocks of V.

    ``V``: anything with ``V.shape`` and ``V[:, a:b]``, e.g.
    ``np.load(path, mmap_mode='r')`` for out-of-core data.  Parameters:
    block_size (4096 columns), epochs (default min(maxiter, 5) passes),
    inner_iters (3 MU encodings per block), forget (the sufficient
    statistics' discount per block, default 1.0: none), W_init,
    return_H (False: skip the final encoding of all of V), tolerance
    (early stop on the epoch cost's decrease), seed, dtype, device (the
    run's device; default the CUDA card), mesh (``parallel.make_mesh``:
    every rank calls with the same arguments; each block is zero-padded
    to the mesh's multiples and each rank reads only its part of it).

    Returns a :class:`Result` as (W, H, cost): W (m, k) a tensor on the
    run's device, H a (k, n) NumPy array assembled on the host (it may
    not fit on the device) or None unless ``return_H``, cost the
    objective per epoch, summed over the streamed blocks in f64 on the
    device and read once per epoch.  The per-block encodings stay on the
    device across epochs as warm starts.
    """
    cfg = merge_config(config, kwargs)
    mesh = check_mesh(cfg.get("mesh"))
    device = resolve_device(V, cfg.get("device"), mesh)
    dtype = resolve_dtype(V, cfg.get("dtype"))
    src = staging_device(V, device, mesh)  # the whole inits until placement
    m, n = V.shape
    k = int(num_basis_elems)
    maxiter, tolerance, eps, gen = common_scalars(cfg)
    epochs = int(cfg.get("epochs", min(maxiter, 5)))
    block = int(cfg.get("block_size", 4096))
    inner = int(cfg.get("inner_iters", 3))
    rho = float(cfg.get("forget", 1.0))

    # The mesh's padded layout: W's rows pad to the feature multiple, each
    # block's columns to the sample multiple; a rank holds rows r0.. of
    # ``rows`` and, of each block, the columns from its coordinate on.
    mmul, nmul = mesh_multiples(mesh)
    pad_m = pad_amount(m, mmul)
    rows = (m + pad_m) // mmul
    r0 = block_offset(mesh, rows, "m")

    def widths(a):  # (true, padded) widths of the block starting at a
        w = min(block, n - a)
        return w, w + pad_amount(w, nmul)

    def local_block(a):
        w, wp = widths(a)
        if mesh is None:
            return blocks.get(a, a + w)
        c0 = a + mesh.coord("n") * (wp // nmul)
        return blocks.get(min(c0, a + w), min(c0 + wp // nmul, a + w),
                          rows=(min(r0, m), min(r0 + rows, m)), shape=(rows, wp // nmul))

    def place(x, spec):
        return x.to(device) if mesh is None else shard(mesh, x, spec)

    W = cfg.get("W_init")
    if W is None:
        W = unit_l2_columns(uniform_init(gen, (m, k), dtype, src))
    W = place(pad_axes(as_tensor(W, dtype, src), {0: pad_m}), ("m", None))
    starts = list(range(0, n, block))
    H_blocks = [place(pad_axes(uniform_init(gen, (k, widths(a)[0]), dtype, src),
                               {1: widths(a)[1] - widths(a)[0]}), (None, "n"))
                for a in starts]
    blocks = _Blocks(V, block, dtype, device,
                     size=rows * (block + pad_amount(block, nmul)))

    A = torch.zeros((rows, k), dtype=dtype, device=device)
    B = torch.zeros((k, k), dtype=dtype, device=device)
    cost = []
    with torch.no_grad():
        for epoch in range(epochs):
            total = torch.zeros((), dtype=torch.float64, device=device)
            for bi, a in enumerate(starts):
                Vb = local_block(a)
                Hb = _encode(Vb, W, H_blocks[bi], inner, eps, mesh)
                H_blocks[bi] = Hb
                Ab, Bb, v_sq = _stats(Vb, Hb, mesh)
                A = rho * A + Ab
                B = rho * B + Bb
                W = _update_w(W, A, B, eps, mesh)
                # f32 -> f64 is exact and the blocks add in order, so this
                # is the JAX package's Python float sum, without a read.
                total += _block_cost(v_sq, Vb, W, Hb, mesh)
                del Vb
            cost.append(float(total))  # the one read of an epoch
            if (epoch > 0 and cost[-1] < cost[-2]
                    and cost[-2] - cost[-1] < tolerance):
                break

        H = None
        if cfg.get("return_H", False):
            H = np.concatenate(
                [gather_factor(mesh, _encode(local_block(a), W, H_blocks[bi], inner,
                                             eps, mesh), "n", 1)[:, :widths(a)[0]].cpu().numpy()
                 for bi, a in enumerate(starts)], axis=1)
        W = gather_factor(mesh, W, "m", 0)[:m]
    return Result(fields=("W", "H", "cost"), W=W, H=H, cost=np.asarray(cost),
                  n_iters=len(cost), converged=len(cost) < epochs)


def nmf_encode_streaming(V, W, config: dict | None = None, **kwargs):
    """EXACT out-of-core encoding of one wide V against a frozen
    dictionary: the streaming counterpart of ``nmf_encode``.

    With W fixed, every MU H update is column-local (nmf.m:178-199), so
    encoding column blocks one at a time reproduces the in-memory
    ``nmf(V, k, W_init=W, W_fixed=True)`` trajectory; only (m, block)
    slices reach the device, and V can be a memmap.

    Parameters: block_size (4096), divergence (the nmf family),
    alpha/beta, H_sparsity, H_init ((k, n) indexable, sliced per block;
    default uniform per block from ``seed``), weights ((m, n) indexable,
    sliced per block), maxiter (100), seed, dtype, eps, device (default
    the CUDA card), out (a writable (k, n) array, e.g. an np.memmap: the
    H blocks are written in place and the Result carries ``H=out``).
    ``mesh`` raises ``ValueError``, as in the JAX package: this is the
    one-device out-of-core path.  Returns a :class:`Result` with W (m, k,
    unit-L2 columns) a tensor on the run's device, H (k, n) a NumPy array
    (or ``out``) and cost (maxiter,), the per-iteration objective summed
    over the blocks in f64.
    """
    from .batched import nmf_encode

    cfg = merge_config(config, kwargs)
    block = int(cfg.pop("block_size", 4096) or 4096)
    out = cfg.pop("out", None)
    if cfg.get("mesh") is not None:
        raise ValueError("nmf_encode_streaming is the single-device "
                         "out-of-core path; use nmf_encode(mesh=) for "
                         "in-memory multi-chip encoding")
    m, n = V.shape
    device = resolve_device(V, cfg.get("device"))
    dtype = resolve_dtype(V[:, :1], cfg.get("dtype"))
    W = as_tensor(W, dtype, device)
    if W.ndim != 2 or W.shape[0] != m:
        raise ValueError(f"dictionary W must be (m, k) = ({m}, k); got "
                         f"{tuple(W.shape)}")
    k = W.shape[1]
    W = unit_l2_columns(W)  # idempotent with nmf_encode's own entry norm
    H_init = cfg.pop("H_init", None)
    weights = cfg.pop("weights", None)
    maxiter, _, _, gen = common_scalars(cfg)
    cfg.pop("tolerance", None)  # a fixed-iteration engine, like nmf_encode
    cfg.pop("maxiter", None)    # passed explicitly below

    if out is not None and np.shape(out) != (k, n):
        raise ValueError(f"out must be a writable (k, n) = {(k, n)} array; "
                         f"got {np.shape(out)}")
    blocks = _Blocks(V, block, dtype, device)
    parts = [] if out is None else None
    cost = np.zeros(maxiter, np.float64)
    for a in range(0, n, block):
        b = min(a + block, n)
        if H_init is not None:
            Hb0 = as_tensor(H_init[:, a:b], dtype, device)[None]
        else:
            Hb0 = uniform_init(gen, (1, k, b - a), dtype, device)
        bcfg = dict(cfg)
        if weights is not None:
            bcfg["weights"] = as_tensor(weights[:, a:b], dtype, device)
        res = nmf_encode(blocks.get(a, b)[None], W, H_init=Hb0, maxiter=maxiter,
                         **bcfg)
        cost += np.asarray(res.cost[0], np.float64)
        Hb = res.H[0].cpu().numpy()
        if out is None:
            parts.append(Hb)
        else:
            out[:, a:b] = Hb
    H = out if out is not None else np.concatenate(parts, axis=1)
    return Result(fields=("W", "H", "cost"), W=W, H=H, cost=cost,
                  n_iters=maxiter, converged=False)
