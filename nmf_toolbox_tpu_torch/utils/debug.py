"""Tracing, profiling, and numerical-debug helpers (PyTorch counterpart of
``nmf_toolbox_tpu/utils/debug.py``).

* ``trace(label)``: a ``torch.profiler.record_function`` range around a
  block, which a profile shows as a span named ``label``; it records only
  while a profiler records (``core.span``, the port's own spans' primitive,
  under its public name), and costs one read of the profiler's state
  otherwise.
* ``profile_to(logdir)``: capture a ``torch.profiler`` profile around a
  block (CPU ops, and the card's kernels when CUDA is available) and
  write it to ``logdir`` as a Chrome trace.
* ``check_finite(result)``: post-hoc guard that factors and cost are
  finite.
* ``iteration_logger()``: a ``callback(i, cost)`` printing the
  per-iteration cost, for ``nmf(callback=...)`` (opt-in; the run then
  reads the device once per iteration).
* ``emulate_card_matmul_numerics()``: the card's f32 matmul numerics on
  the CPU, to calibrate gate thresholds with no chip time (the
  counterpart of the JAX package's ``emulate_tpu_matmul_numerics``).
"""
from __future__ import annotations

import contextlib
import contextvars
import os
import time

import numpy as np
import torch

from ..core import span, to_host
from ..ops.kernels import tf32


# Profiler annotation, ``with trace("nmf"): nt.nmf(...)``: recorded only
# under a profiler (``profile_to``, ``torch.profiler``).
trace = span


@contextlib.contextmanager
def profile_to(logdir: str):
    """Profile the block and write ``logdir/trace_<pid>_<ns>.json``, a
    Chrome trace (chrome://tracing, Perfetto)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def check_finite(result) -> None:
    """Raise if any factor or the cost trace contains NaN/Inf."""
    for f in result.fields:
        val = getattr(result, f)
        arrs = val if isinstance(val, (list, tuple)) else [val]
        for a in arrs:
            if a is None:
                continue
            if not np.all(np.isfinite(to_host(a))):
                raise FloatingPointError(
                    f"non-finite values in result field '{f}'")


def iteration_logger(prefix: str = "iter"):
    """Returns a callback(iteration, cost) -> None for a solver's
    ``callback=``."""
    def cb(i, c):
        print(f"{prefix} {int(i) + 1}: cost = {float(c):.6e}")
    return cb


# The matmul family the port calls, each with the argument positions of
# its two operands ("einsum": every tensor after the equation).  A GEMM
# is what cuBLAS runs in TF32 under fp32_precision "tf32"; a product with
# a vector operand, or with one row or one column out, runs as a GEMV,
# which does not use the tensor cores (measured on the card).
_TB = torch._C.TensorBase
_FAMILY = {
    **dict.fromkeys((torch.matmul, _TB.matmul, _TB.__matmul__, torch.Tensor.__rmatmul__,
                     torch.mm, _TB.mm, torch.bmm, _TB.bmm, torch.mv, _TB.mv), (0, 1)),
    **dict.fromkeys((torch.addmm, _TB.addmm, torch.addmv, _TB.addmv), (1, 2)),
    torch.einsum: None,
}
# The bilinear members: the kernels' plain versions' products, which the
# emulation runs in 3xTF32 (addmm and addmv add a third term).
_BILINEAR = {torch.matmul, _TB.matmul, _TB.__matmul__, torch.Tensor.__rmatmul__, torch.mm,
             _TB.mm, torch.bmm, _TB.bmm, torch.einsum}

# How cuBLAS rounds an f32 operand to TF32 on the card: nearest, ties to
# even (benchmarks_torch/tf32_rounding.py; chip_smoke.py phase 5b holds
# the emulation to the card).
CARD_TF32_ROUNDING = tf32.tf32_rne

_EMULATING = contextvars.ContextVar("nmf_emulating_card_matmul", default=False)


def _precision(backend) -> str:
    """A backend's effective fp32_precision: its own, else the generic
    ``torch.backends.fp32_precision``, else "ieee"."""
    own = backend.fp32_precision
    if own == "none":
        own = torch.backends.fp32_precision
    return "ieee" if own == "none" else own


def _check_onednn():
    if _precision(torch.backends.mkldnn.matmul) != "ieee":
        raise RuntimeError(
            "emulate_card_matmul_numerics needs oneDNN's own f32 matmuls at full "
            "precision (torch.backends.mkldnn.matmul.fp32_precision 'ieee' or "
            "'none'): with bf16 or TF32 there the CPU rounds the operands itself "
            "and the emulation's rounding would be doubled; set the card's "
            "precision through torch.backends.cuda.matmul.fp32_precision alone")


def _is_gemm(func, ops) -> bool:
    """Whether cuBLAS runs this product as a GEMM: every operand a matrix
    (or a batch of them) and, but for einsum, more than one row and more
    than one column out."""
    if not all(x.ndim >= 2 for x in ops):
        return False
    a, b = ops[::-1] if func is torch.Tensor.__rmatmul__ else ops
    return func is torch.einsum or (a.shape[-2] > 1 and b.shape[-1] > 1)


class _CardMatmul(torch.overrides.TorchFunctionMode):
    """The function mode of :func:`emulate_card_matmul_numerics`."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func not in _FAMILY:
            return func(*args, **kwargs)
        _check_onednn()
        if func is torch.einsum and len(args) == 2 and isinstance(args[1], (list, tuple)):
            args = (args[0], *args[1])  # einsum(eq, [a, b]) as einsum(eq, a, b)
        pos = _FAMILY[func] or tuple(range(1, len(args)))
        if len(args) <= max(pos):
            return func(*args, **kwargs)
        ops = [args[i] for i in pos]
        if not all(torch.is_tensor(x) and x.dtype == torch.float32
                   and x.device.type == "cpu" for x in ops):
            return func(*args, **kwargs)

        def call(*new):
            a = list(args)
            for i, x in zip(pos, new):
                a[i] = x
            return func(*a, **kwargs)

        if tf32.in_kernel_products() and func in _BILINEAR and len(ops) == 2:
            return tf32.mm3(*ops, product=call)
        if _precision(torch.backends.cuda.matmul) == "tf32" and _is_gemm(func, ops):
            return call(*(CARD_TF32_ROUNDING(x) for x in ops))
        return call(*ops)


@contextlib.contextmanager
def emulate_card_matmul_numerics():
    """CPU-side emulation of the card's f32 matmul numerics.

    Inside the context, on CPU f32 tensors:

    * every GEMM of the matmul family the port calls (``@``/``matmul``,
      ``mm``, ``bmm``, ``addmm``, ``einsum``) gets the card's operand
      rounding under
      the current ``torch.backends.cuda.matmul.fp32_precision``: with
      "tf32" each operand is rounded to TF32 (:data:`CARD_TF32_ROUNDING`:
      nearest with ties to even, as the H100's cuBLAS rounds, measured by
      ``benchmarks_torch/tf32_rounding.py``) and the product accumulates in
      f32; with "ieee" (or "none") it is left as it is.  Blocks under
      ``core.full_f32_matmul()`` therefore stay full f32, as they do on
      the card (the counterpart of JAX's exemption for
      ``precision="highest"``).  Products with a vector operand (``mv``,
      ``addmv``, ``matmul`` of a vector) or with one row or one column
      out stay f32: the card runs them as GEMVs, off the tensor cores.
    * the plain versions of the fused and dma kernels
      (``ops/kernels/fused.py``, ``fused_dma.py``) compute their products
      in the kernels' 3xTF32 (``ops/kernels/tf32.mm3``), whatever the
      precision setting, as the kernels do.

    Elementwise ops, f64, bf16 and complex products, and tensors on a
    card are untouched.  It calibrates gate thresholds against the worse
    of {CPU f32, the card's numerics} with zero chip time; never use it
    in the product path.  Exit restores everything, on error too.

    Raises ``RuntimeError`` where it would be a no-op or be doubled:
    inside another such context, or when oneDNN's own
    ``torch.backends.mkldnn.matmul.fp32_precision`` is not "ieee" (as
    ``torch.set_float32_matmul_precision("high")`` sets it).
    """
    if _EMULATING.get():
        raise RuntimeError("emulate_card_matmul_numerics is already active: "
                           "nesting it would round the operands twice")
    _check_onednn()
    token = _EMULATING.set(True)
    try:
        with _CardMatmul():
            yield
    finally:
        _EMULATING.reset(token)
