"""The named reductions of the sharded solvers.

JAX places arrays at the boundary and XLA inserts the psums its
partitioner derives.  The port runs each rank's step on its local block
(``parallel/mesh.py``) and says where the sums cross shards:

* over samples (the ``"n"`` axis): V H', H H', the W-phase kernel's
  output, the row sums of H, the sample-side inner products of a cost;
* over features (the ``"m"`` axis): W'V, W'W, the H-phase kernel's
  output, column norms and column sums of W;
* over every rank: a cost's elementwise sums.

Each sum is the identity when ``mesh`` is None, and along an axis the
mesh does not carry; it reduces several tensors in one collective (one
flat buffer, of the first tensor's dtype: never mix real and complex
tensors in one call) and returns them in the order given.  The sums
reduce in place: pass tensors that nothing else holds.

The convolutive solvers shift along the sample axis, so a rank's block
needs the T - 1 columns of its neighbours (:func:`halo`).  Only
``all_reduce`` and ``all_gather`` are used, the halo included: both
carry CUDA tensors over NCCL and Gloo, where Gloo's point-to-point
``send``/``recv`` take CPU tensors only.

Under a profiler each ``all_reduce`` is the span ``collectives.reduce``
and each ``all_gather`` ``collectives.gather`` (``core.span``), with
the copies around it; every rank issues them in the same order.
"""
from __future__ import annotations

import torch

from ..core import span
from .mesh import FEATURE_AXIS, SAMPLE_AXIS

ALIGN = 64  # elements: where each tensor of a multi-tensor sum starts

# Collectives issued through this module (measurement: chip_smoke.py
# phase 16 reads it per iteration).
calls = 0


def _strides(x):
    """x's strides when its elements tile one dense block (a permuted
    row-major layout: a transpose, an unflattened frame stack), else the
    row-major strides of its shape.  A reduced copy keeps them, so the
    products that read it take the kernels the unreduced tensor would."""
    expect, dense = 1, True
    for d in sorted(range(x.ndim), key=x.stride):
        if x.shape[d] != 1 and x.stride(d) != expect:
            dense = False
        expect *= x.shape[d]
    if dense:
        return x.stride()
    out, expect = [], 1
    for size in reversed(x.shape):
        out.append(expect)
        expect *= size
    return tuple(reversed(out))


def _reduce(mesh, axis, xs):
    global calls
    if mesh is None or (axis is not None and axis not in mesh.shape):
        return xs[0] if len(xs) == 1 else xs
    import torch.distributed as dist
    group = None if axis is None else mesh.group(axis)
    calls += 1
    with span("collectives.reduce"):
        if len(xs) == 1 and xs[0].is_contiguous():
            dist.all_reduce(xs[0], group=group)
            return xs[0]
        # Each tensor starts at a multiple of ALIGN elements of the flat
        # buffer, so that the products reading the reduced views find the
        # alignment (and take the kernels) that fresh tensors would.
        starts, at = [], 0
        for x in xs:
            starts.append(at)
            at += -(-x.numel() // ALIGN) * ALIGN
        flat = torch.empty(at, dtype=xs[0].dtype, device=xs[0].device)
        out = tuple(flat.as_strided(x.shape, _strides(x), a) for x, a in zip(xs, starts))
        for view, x in zip(out, xs):
            view.copy_(x)
        dist.all_reduce(flat, group=group)
    return out[0] if len(out) == 1 else out


def sum_axis(mesh, axis, *xs):
    """Sum over the mesh axis ``axis`` ("n", "m"; None: every rank)."""
    return _reduce(mesh, axis, xs)


def sum_samples(mesh, *xs):
    """Sum over the sample axis (the ranks that hold one row block)."""
    return _reduce(mesh, SAMPLE_AXIS, xs)


def sum_features(mesh, *xs):
    """Sum over the feature axis (the ranks that hold one column block)."""
    return _reduce(mesh, FEATURE_AXIS, xs)


def sum_all(mesh, *xs):
    """Sum over every rank of the mesh."""
    return _reduce(mesh, None, xs)


def _gather(group, size: int, x, dim: int):
    """The blocks that the ``size`` ranks of ``group`` hold along ``dim``,
    joined in rank order, on every rank."""
    global calls
    import torch.distributed as dist
    calls += 1
    with span("collectives.gather"):
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=dim)


def halo(mesh, x, width: int, side: str):
    """The ``width`` columns (last axis) of the sample-sharded ``x`` that
    lie just before (``side="left"``) or just after (``"right"``) this
    rank's block, in global order, with zeros past the global edge; all
    zeros with no mesh or one rank on the sample axis.

    One ``all_gather`` of every rank's boundary columns: its last (or
    first) ``width`` columns, or its whole block when the block is
    narrower, so that a halo may span several neighbours."""
    global calls
    size = 1 if mesh is None else mesh.size(SAMPLE_AXIS)
    if width <= 0 or size == 1:
        return x.new_zeros(x.shape[:-1] + (max(width, 0),))
    import torch.distributed as dist
    b = x.shape[-1]
    w = min(width, b)
    calls += 1
    with span("collectives.gather"):
        edge = (x[..., b - w:] if side == "left" else x[..., :w]).contiguous()
        parts = [torch.empty_like(edge) for _ in range(size)]
        dist.all_gather(parts, edge, group=mesh.group(SAMPLE_AXIS))
    r, reach = mesh.coord(SAMPLE_AXIS), -(-width // w)  # neighbours it spans
    zero = torch.zeros_like(edge)
    if side == "left":
        got = [parts[j] if j >= 0 else zero for j in range(r - reach, r)]
        return torch.cat(got, dim=-1)[..., -width:]
    got = [parts[j] if j < size else zero for j in range(r + 1, r + 1 + reach)]
    return torch.cat(got, dim=-1)[..., :width]


def gather_factor(mesh, x, axis: str, dim: int):
    """The whole tensor whose blocks along ``dim`` the ranks of ``axis``
    hold, in the axis' order, on every rank; ``x`` itself with no mesh
    or an axis the mesh does not carry."""
    if mesh is None or axis not in mesh.shape:
        return x
    if x.is_complex():
        return torch.view_as_complex(
            gather_factor(mesh, torch.view_as_real(x), axis, dim))
    return _gather(mesh.group(axis), mesh.size(axis), x, dim)


def dtensor_whole(x):
    """The whole tensor of a ``DTensor`` whose shards divide evenly (a
    restore of ``utils.load_factors_orbax``), gathered over each sharded
    mesh dimension's group.  Not ``DTensor.full_tensor()``: its
    functional collectives hung over Gloo on CUDA tensors (torch 2.11,
    H100)."""
    local = x.to_local()
    for i, p in enumerate(x.placements):
        if p.is_shard():
            local = _gather(x.device_mesh.get_group(i), x.device_mesh.size(i),
                            local, p.dim)
    return local
