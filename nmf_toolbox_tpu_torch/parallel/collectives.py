"""The named reductions of the sharded solvers.

JAX places arrays at the boundary and XLA inserts the psums its
partitioner derives.  The port runs each rank's step on its local block
(``parallel/mesh.py``) and says where the sums cross shards:

* over samples (the ``"n"`` axis): V H', H H', the W-phase kernel's
  output, the row sums of H, the sample-side inner products of a cost;
* over features (the ``"m"`` axis): W'V, W'W, the H-phase kernel's
  output, column norms and column sums of W;
* over every rank: a cost's elementwise sums.

Each function is the identity when ``mesh`` is None, and along an axis
the mesh does not carry; it reduces several tensors in one collective
(one flat buffer) and returns them in the order given.  The sums reduce
in place: pass tensors that nothing else holds.  Only ``all_reduce`` and
``all_gather`` are used; both carry CUDA tensors over NCCL and Gloo.
"""
from __future__ import annotations

import torch

from .mesh import FEATURE_AXIS, SAMPLE_AXIS

ALIGN = 64  # elements: where each tensor of a multi-tensor sum starts

# Collectives issued through this module (measurement: chip_smoke.py
# phase 16 reads it per iteration).
calls = 0


def _reduce(mesh, axis, xs):
    global calls
    if mesh is None or (axis is not None and axis not in mesh.shape):
        return xs[0] if len(xs) == 1 else xs
    import torch.distributed as dist
    group = None if axis is None else mesh.group(axis)
    calls += 1
    if len(xs) == 1:
        x = xs[0].contiguous()
        dist.all_reduce(x, group=group)
        return x
    # Each tensor starts at a multiple of ALIGN elements of the flat
    # buffer, so that the products reading the reduced views find the
    # alignment (and take the kernels) that fresh tensors would.
    starts, at = [], 0
    for x in xs:
        starts.append(at)
        at += -(-x.numel() // ALIGN) * ALIGN
    flat = torch.empty(at, dtype=xs[0].dtype, device=xs[0].device)
    for x, a in zip(xs, starts):
        flat[a:a + x.numel()].copy_(x.reshape(-1))
    dist.all_reduce(flat, group=group)
    return tuple(flat[a:a + x.numel()].view(x.shape) for x, a in zip(xs, starts))


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
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


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
