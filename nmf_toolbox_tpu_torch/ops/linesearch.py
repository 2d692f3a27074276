"""Backtracking projected-gradient line search (nmfsc.m:152-179).

PyTorch counterpart of ``nmf_toolbox_tpu/ops/linesearch.py``, shared by
nmfsc and cnmfsc: trial step, project, accept when the objective does
not increase, halve otherwise, declare convergence when the stepsize
underflows (nmfsc.m:170-174), grow 1.2x on success (nmfsc.m:178).  On
underflow X is returned unchanged (MATLAB returns the un-accepted
factor).

The JAX package runs each search as an on-device ``while_loop``.  Here
the loop runs on the host: the stepsize is a host scalar rounded in the
factor's dtype (so it takes JAX's values), and each trial (or each
round of the parallel search) reads its acceptance flags once.  The
objective ``obj_fn`` takes a factor with an optional leading batch of
candidates and returns one value per candidate; ``project`` likewise
projects every candidate of a batch.
"""
from __future__ import annotations

import torch

from ..core import STEP_UNDERFLOW, host_read


def underflow_threshold(dtype) -> float:
    """Stepsize below which the search declares convergence.

    MATLAB's 1e-200 (nmfsc.m:170) assumes double precision; in float32
    1e-200 rounds to 0.0 and ``step < 0.0`` can never fire, so a search
    whose trials never accept (possible once fp noise in the objective
    exceeds the true decrease) would halve the step to 0 and loop
    forever.  Clamp to the dtype's smallest normal instead; f64
    semantics (reference parity) are unchanged since tiny(f64) < 1e-200.
    """
    return max(STEP_UNDERFLOW, float(torch.finfo(dtype).tiny))


def host_scalar_type(dtype: torch.dtype):
    """The NumPy scalar type of a torch dtype: host stepsizes round in
    the factor's precision, as JAX's on-device stepsizes do."""
    return torch.empty(0, dtype=dtype).numpy().dtype.type


def backtracking_search(obj_fn, X, dX, step0, project, begobj):
    """Sequential halving.  Returns (X_out, step_out, underflow,
    last_obj) with the stepsize a host scalar of X's dtype; one host read
    per trial."""
    t = host_scalar_type(X.dtype)
    thr = underflow_threshold(X.dtype)
    step = t(step0)
    while True:
        Xnew = project(X - float(step) * dX)
        newobj = obj_fn(Xnew)
        if host_read(newobj <= begobj):
            return Xnew, t(t(1.2) * step), False, newobj
        step = t(step / t(2))
        if step < thr:
            return X, step, True, newobj


def parallel_backtracking_search(obj_fn, X, dX, step0, project, begobj,
                                 width: int):
    """Batched backtracking: ``width`` successive halvings of the step
    projected side by side in ONE ``project`` call and evaluated in one
    batched objective per round, with one host read per round.

    Takes the decisions of :func:`backtracking_search`: the accepted
    candidate is the FIRST step in halving order whose objective does not
    increase, and an underflow strictly before the first acceptable
    candidate pre-empts it (sequential halving would reach it first).
    """
    t = host_scalar_type(X.dtype)
    thr = underflow_threshold(X.dtype)
    step = t(step0)
    while True:
        steps = [t(step * t(0.5 ** j)) for j in range(width)]
        st = torch.tensor([float(s) for s in steps], dtype=X.dtype, device=X.device)
        Xp = project(X - st.reshape((-1,) + (1,) * X.ndim) * dX)
        objs = obj_fn(Xp)
        acc = host_read(objs <= begobj)
        under = [t(s / t(2)) < thr for s in steps]
        j_acc = acc.index(True) if any(acc) else width
        j_und = under.index(True) if any(under) else width
        # trial j_acc is evaluated (and accepted) before its own halve
        # check, so acceptance wins a tie
        if j_acc < width and j_acc <= j_und:
            return Xp[j_acc], t(t(1.2) * steps[j_acc]), False, objs[j_acc]
        if j_und < width:
            return X, t(steps[j_und] / t(2)), True, objs[j_und]
        step = t(steps[-1] / t(2))


def resolve_width(value) -> int:
    """The ``linesearch_width`` knob: ``None`` / ``"auto"`` -> 0 (the
    reference's sequential halving; the JAX package picks 8 only on a
    TPU), an integer forces that width (0 = sequential)."""
    if value is None or (isinstance(value, str) and value == "auto"):
        return 0
    return int(value)


def make_search(width: int):
    """Search-function factory: 0 = reference sequential halving,
    >0 = parallel backtracking with that batch width."""
    if width <= 0:
        return backtracking_search

    def search(obj_fn, X, dX, step0, project, begobj):
        return parallel_backtracking_search(obj_fn, X, dX, step0, project,
                                            begobj, width)
    return search

