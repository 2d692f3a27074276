"""Hoyer projection kernel.

The kernel behind :func:`~nmf_toolbox_tpu_torch.ops.projection.project_rows`
on a card (a budget of N + 1 passes: the JAX package's while_loop) and
:func:`~nmf_toolbox_tpu_torch.ops.projection.project_rows_bounded` (the
phased nmfsc dispatch's pass budget).  The CUDA source is
``csrc/hoyer.cu``.

``hoyer_project(S, k1, k2, passes, valid=None)`` projects every vector
``S[..., :]`` (the last axis; leading axes are batch) onto {sum = k1,
sum of squares = k2, >= 0} in at most ``min(passes, N + 1)`` passes of
the port's projection pass (``ops/projection._pass``), each vector
frozen once it is done, and returns ``(v, done, iters)``: the
projections (in S's layout where its entries are contiguous, else
contiguous), each vector's done flag and its pass count.  ``S`` is
float32 or float64, any strides; ``k1`` and ``k2`` are scalars or
tensors that broadcast over the batch; entries at or past
``valid`` start zeroed, as :func:`project_rows` pads them.  Tensors on
the CPU go to the plain PyTorch version beside it
(:func:`hoyer_project_reference`); tensors on a CUDA device launch the
kernel on the current stream, or raise.  Nothing falls back.  Each
launch adds one to ``hoyer_project_launches``.
"""
from __future__ import annotations

import ctypes
import numbers

import torch

from . import _build
from .fused import _raise_on
from .. import projection

hoyer_project_launches = 0
_lib = None  # the kernel library, loaded at the first launch


# ---------------------------------------------------------------------------
# Replaces: no pallas_call.  It stands for the device loops of the JAX
#   package's projection: the lax.while_loop of
#   nmf_toolbox_tpu/ops/projection.py project_columns (:55-58, 89) and the
#   lax.fori_loop of nmf_toolbox_tpu/models/nmfsc_phased.py
#   _project_columns_bounded (:70), which XLA runs on the device.
# Bound on the H100: bytes, one read of S and one write of v at 3.35 TB/s.
# Design: each vector is read once, held on chip for every pass and
#   written once.  A short vector lives in the registers of one CTA, a long
#   one in those of a thread-block cluster (up to 16 CTAs) whose per-pass
#   sums meet in distributed shared memory; vectors longer than a cluster
#   holds stream through global memory in one CTA each.  One table by
#   length and dtype (nmf_hoyer_tier) picks the tier.  Each half-pass's
#   three sums go through one reduction in a fixed order (identical bits
#   over reruns and over a cluster's CTAs); a vector leaves its loop once
#   done, which is exact.  The kernel takes any batch strides and
#   contiguous entries; the wrapper copies strided entries (W's columns as
#   rows of W.mT) contiguous first, which costs less than reading them in
#   place (PERF.md).  See csrc/hoyer.cu.
# ---------------------------------------------------------------------------

def _check(S, passes, valid):
    """N, the vectors' length; raises on what the kernel does not take."""
    if not torch.is_tensor(S) or S.ndim < 1 or S.dtype not in (torch.float32, torch.float64):
        raise TypeError("S must be a float32 or float64 tensor with at least one axis")
    N = S.shape[-1]
    if N < 1:
        raise ValueError("the projected vectors must have at least one entry")
    if int(passes) < 0:
        raise ValueError(f"passes must be >= 0, got {passes}")
    if valid is not None and int(valid) < 1:
        raise ValueError(f"valid must be >= 1, got {valid}")
    return N


def hoyer_project_reference(S, k1, k2, passes: int, valid: int | None = None):
    """Plain PyTorch version of :func:`hoyer_project`: the loop of
    ``ops/projection.project_rows`` (no mesh) with a pass budget and no
    host read.  On a CPU tensor it stops once every vector is done (the
    rest of the budget would change nothing, and the check reads no
    device); on a card it runs the whole budget."""
    N = _check(S, passes, valid)
    v, zero, nz, k1, k2 = projection.start(S, k1, k2, valid)
    zero_t = torch.zeros((), dtype=S.dtype, device=S.device)
    done = torch.zeros(S.shape[:-1], dtype=torch.bool, device=S.device)
    iters = torch.zeros(S.shape[:-1], dtype=torch.int32, device=S.device)
    for _ in range(min(int(passes), N + 1)):
        if S.device.type == "cpu" and bool(torch.all(done)):
            break
        v, zero, nz, done, iters = projection._pass(v, zero, nz, done, iters, k1, k2, zero_t)
    return v, done, iters


def _library():
    global _lib
    if _lib is None:
        _lib = _build.load()
    return _lib


def tier(N: int, dtype) -> tuple[int, int, int, int]:
    """(index, threads per CTA, entries per thread, CTAs per vector) of the
    kernel's tier for vectors of length N (entries 0: the streaming tier),
    from the library's table (``nmf_hoyer_tier``); builds the library."""
    info = (ctypes.c_int * 3)()
    index = _library().nmf_hoyer_tier(int(N), int(dtype == torch.float64), info)
    if index < 0:
        raise ValueError(f"no tier for vectors of length {N}")
    return index, info[0], info[1], info[2]


def _target(k, batch, S):
    """(tensor kept alive or None, pointer, stride, value) for k1 or k2: a
    number goes by value; a tensor on the card by pointer, stride 0 for one
    value (nothing is read back) and 1 over the batch."""
    if isinstance(k, numbers.Real):
        return None, 0, 0, float(k)
    t = torch.as_tensor(k)
    if t.numel() == 1 and t.device.type == "cpu":
        return None, 0, 0, float(t)
    t = t.to(device=S.device, dtype=S.dtype)
    if t.numel() == 1:
        return t, t.data_ptr(), 0, 0.0
    t = t.expand(batch).reshape(-1).contiguous()
    return t, t.data_ptr(), 1, 0.0


def hoyer_project(S, k1, k2, passes: int, valid: int | None = None):
    """(v, done, iters): every vector of S projected in at most
    ``min(passes, N + 1)`` passes, by the kernel on a CUDA tensor."""
    global hoyer_project_launches
    N = _check(S, passes, valid)
    if S.device.type == "cpu":
        return hoyer_project_reference(S, k1, k2, passes, valid)
    if S.device.type != "cuda":
        raise ValueError(f"no kernel for device {S.device}")
    batch = S.shape[:-1]
    # (B0, B1, N) with batch strides: a 3-D or smaller S as it is, a
    # deeper one reshaped (a view where its batch axes merge).  The kernel
    # takes contiguous entries: strided ones (W's columns as rows of W.mT)
    # are copied first, as a warp reading them in place uses 4 or 8 bytes
    # of each 32-byte sector it loads.
    x = S if S.ndim <= 3 else S.reshape(-1, S.shape[-2], N)
    if x.stride(-1) != 1 and N > 1:
        x = x.contiguous()
    v = torch.empty_like(x)  # x's strides where x is dense, else contiguous
    done = torch.empty(batch, dtype=torch.bool, device=S.device)
    iters = torch.empty(batch, dtype=torch.int32, device=S.device)
    B = x.numel() // N
    if B == 0:
        return v if S.ndim <= 3 else v.reshape(S.shape), done, iters
    pad = (0,) * (3 - x.ndim)
    s0, s1 = (pad + x.stride())[:2]
    v0, v1 = (pad + v.stride())[:2]
    B1 = x.shape[-2] if x.ndim >= 2 else 1
    t1, p1, st1, c1 = _target(k1, batch, S)
    t2, p2, st2, c2 = _target(k2, batch, S)
    lib = _library()
    args = (x.data_ptr(), v.data_ptr(), done.data_ptr(), iters.data_ptr(), B, B1, N,
            N if valid is None else min(int(valid), N), s0, s1, v0, v1,
            p1, st1, c1, p2, st2, c2, min(int(passes), N + 1),
            int(S.dtype == torch.float64))
    # the raw current stream of S's card (torch.cuda.current_stream() costs
    # several µs more a call, which a host-bound line search pays)
    index = S.get_device()
    if index == torch.cuda.current_device():
        err = lib.nmf_hoyer_project(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = lib.nmf_hoyer_project(*args, torch._C._cuda_getCurrentRawStream(index))
    del t1, t2  # kept alive until the kernel was queued
    _raise_on(lib, "nmf_hoyer_project", err)
    hoyer_project_launches += 1
    return v if S.ndim <= 3 else v.reshape(S.shape), done, iters
