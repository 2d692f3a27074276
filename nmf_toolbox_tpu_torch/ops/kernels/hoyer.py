"""Bounded Hoyer projection kernel.

The kernel behind :func:`~nmf_toolbox_tpu_torch.ops.projection.project_rows_bounded`,
which the phased nmfsc dispatch (``models/nmfsc_phased.py``) calls for
every line-search trial.  The CUDA source is ``csrc/hoyer.cu``.

``hoyer_project(S, k1, k2, passes)`` projects every vector ``S[..., :]``
(the last axis; leading axes are batch) onto {sum = k1, sum of squares
= k2, >= 0} in at most ``min(passes, N + 1)`` passes of the port's
projection pass (``ops/projection._pass``), each vector frozen once it
is done, and returns ``(v, done, iters)``: the projections, each
vector's done flag and its pass count.  ``S`` is float32 or float64;
``k1`` and ``k2`` are Python scalars.  Tensors on the CPU go to the
plain PyTorch version beside it (:func:`hoyer_project_reference`);
tensors on a CUDA device launch the kernel on the current stream, or
raise.  Nothing falls back.  Each launch adds one to
``hoyer_project_launches``.
"""
from __future__ import annotations

import math

import torch

from . import _build
from .fused import _raise_on
from .. import projection

hoyer_project_launches = 0


# ---------------------------------------------------------------------------
# Replaces: no pallas_call.  It stands for the lax.fori_loop of
#   nmf_toolbox_tpu/models/nmfsc_phased.py _project_columns_bounded (:70),
#   which XLA runs on the device inside one program per phased iteration.
# Bound on the H100: bytes, one read of S and one write of v at 3.35 TB/s.
# Design: one block per vector; each pass takes its six per-vector sums by
#   warp shuffles and a fixed shared-memory tree (no atomics, identical bits
#   over reruns); v lives in the output buffer and the zero mask in a byte
#   scratch; a block leaves its pass loop once its vector is done, which is
#   exact.  See csrc/hoyer.cu.
# ---------------------------------------------------------------------------

def _check(S, passes):
    if not torch.is_tensor(S) or S.ndim < 1 or S.dtype not in (torch.float32, torch.float64):
        raise TypeError("S must be a float32 or float64 tensor with at least one axis")
    if S.shape[-1] < 1:
        raise ValueError("the projected vectors must have at least one entry")
    if int(passes) < 0:
        raise ValueError(f"passes must be >= 0, got {passes}")


def hoyer_project_reference(S, k1, k2, passes: int):
    """Plain PyTorch version of :func:`hoyer_project`: the loop of
    ``ops/projection.project_rows`` (no mesh, no padding) with a pass
    budget and no host read.  On a CPU tensor it stops once every vector
    is done (the rest of the budget would change nothing, and the check
    reads no device); on a card it runs the whole budget."""
    _check(S, passes)
    N = S.shape[-1]
    dt, dev = S.dtype, S.device
    batch = S.shape[:-1]
    k1 = torch.as_tensor(k1, dtype=dt, device=dev).expand(batch)
    k2 = torch.as_tensor(k2, dtype=dt, device=dev).expand(batch)
    zero_t = torch.zeros((), dtype=dt, device=dev)
    v = S + ((k1 - torch.sum(S, dim=-1)) / N)[..., None]  # projfunc.m:22
    zero = torch.zeros(S.shape, dtype=torch.bool, device=dev)
    nz = torch.zeros(batch, dtype=dt, device=dev)
    done = torch.zeros(batch, dtype=torch.bool, device=dev)
    iters = torch.zeros(batch, dtype=torch.int32, device=dev)
    for _ in range(min(int(passes), N + 1)):
        if dev.type == "cpu" and bool(torch.all(done)):
            break
        v, zero, nz, done, iters = projection._pass(
            v, zero, nz, done, iters, k1, k2, N, zero_t, lambda *xs: xs)
    return v, done, iters


def hoyer_project(S, k1, k2, passes: int):
    """(v, done, iters): every vector of S projected in at most
    ``min(passes, N + 1)`` passes, by the kernel on a CUDA tensor."""
    global hoyer_project_launches
    _check(S, passes)
    if S.device.type == "cpu":
        return hoyer_project_reference(S, k1, k2, passes)
    if S.device.type != "cuda":
        raise ValueError(f"no kernel for device {S.device}")
    N = S.shape[-1]
    batch = S.shape[:-1]
    B = math.prod(batch)
    x = S.contiguous()
    dev = S.device
    v = torch.empty(x.shape, dtype=S.dtype, device=dev)
    done = torch.empty(batch, dtype=torch.bool, device=dev)
    iters = torch.empty(batch, dtype=torch.int32, device=dev)
    if B == 0:
        return v, done, iters
    zero = torch.empty(x.shape, dtype=torch.uint8, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.nmf_hoyer_project(
            x.data_ptr(), v.data_ptr(), zero.data_ptr(), done.data_ptr(), iters.data_ptr(),
            B, N, min(int(passes), N + 1), float(k1), float(k2),
            int(S.dtype == torch.float64), torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, "nmf_hoyer_project", err)
    hoyer_project_launches += 1
    return v, done, iters
