"""Tracing, profiling, and numerical-debug helpers (PyTorch counterpart of
``nmf_toolbox_tpu/utils/debug.py``).

* ``trace(label)``: a ``torch.profiler.record_function`` range around a
  block, which a profile shows as a span named ``label``.
* ``profile_to(logdir)``: capture a ``torch.profiler`` profile around a
  block (CPU ops, and the card's kernels when CUDA is available) and
  write it to ``logdir`` as a Chrome trace.
* ``check_finite(result)``: post-hoc guard that factors and cost are
  finite.
* ``iteration_logger()``: a ``callback(i, cost)`` printing the
  per-iteration cost, for ``nmf(callback=...)`` (opt-in; the run then
  reads the device once per iteration).

The JAX package's ``emulate_tpu_matmul_numerics`` models the TPU's bf16
matrix unit and has no counterpart here; the port's numerics model of
its tensor-core kernels is ``tests/test_torch_tf32.py``.
"""
from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from ..core import to_host


def trace(label: str):
    """Profiler annotation: ``with trace('nmf'): nt.nmf(...)``."""
    return torch.profiler.record_function(label)


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
