"""The comparison that decides `correct`.

A run hands over, for every solve of its window, the cost trace and
``n_iters`` that the program returned, and for the solve drawn from the
seed also its W and H.  The plain reference that the configuration
names works that solve out again from the same V, inits (and M) and the
numbers below are set beside the traffic file's ``limits``:

* ``cost_gap``: the largest relative gap between the program's and the
  reference's cost at one iteration, over the iterations both ran;
* ``W_gap``, ``H_gap``: ``||X - X_ref|| / ||X_ref||`` (Frobenius) of the
  factors after the program's ``n_iters`` iterations (on a mesh, the
  gathered factors);
* ``stop_breaks``: over every solve of the window, the iterations at
  which the returned trace and ``n_iters`` disagree with the stop rule
  at the run's tolerance, evaluated in f32 as the program states it
  (exact, limit 0).
"""
from __future__ import annotations

import numpy as np

NUMBERS = ("cost_gap", "W_gap", "H_gap", "stop_breaks")


def stop_breaks(cost, n_iters, stopped, tolerance) -> int:
    """Iterations where ``cost`` (the returned trace) and the stop rule
    ``c[i] < c[i-1] and c[i-1] - c[i] < tol`` (f32) disagree: the rule
    must hold at the last iteration of a stopped solve and nowhere
    before, and nowhere in a solve that ran out of iterations."""
    c = np.asarray(cost, dtype=np.float32)
    tol = np.float32(tolerance)
    fires = np.zeros(len(c), dtype=bool)
    if len(c) > 1:
        fires[1:] = (c[1:] < c[:-1]) & ((c[:-1] - c[1:]) < tol)
    want = np.zeros(len(c), dtype=bool)
    if stopped:
        want[-1] = True
    breaks = int(np.sum(fires != want))
    return breaks + (0 if len(c) == int(n_iters) else 1)


def rel_norm_gap(torch, X, X_ref) -> float:
    X, X_ref = X.to(X_ref.device).double(), X_ref.double()
    return float(torch.linalg.norm(X - X_ref) / torch.linalg.norm(X_ref))


def trajectory_gaps(torch, cost, n_iters, W, H, ref) -> dict:
    """cost_gap, W_gap and H_gap of one solve against a reference run
    (the solver's ``reference_solve`` with a snapshot at ``n_iters``)."""
    c = np.asarray(cost, dtype=np.float64)
    r = np.asarray(ref["cost"], dtype=np.float64)
    both = min(len(c), len(r))
    cost_gap = float(np.max(np.abs(c[:both] - r[:both]) / np.abs(r[:both])))
    W_ref, H_ref = ref["snap"][int(n_iters)]
    return {"cost_gap": cost_gap, "W_gap": rel_norm_gap(torch, W, W_ref),
            "H_gap": rel_norm_gap(torch, H, H_ref)}


def judge(numbers: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}) over the numbers the traffic
    file gives a limit: each at or under it; a NaN or a missing number
    fails.  A number with no limit is not compared (its two readings did
    not separate; PERF.md names it)."""
    unknown = set(limits) - set(NUMBERS)
    if unknown:
        raise KeyError(f"limits for numbers check.py does not compute: {sorted(unknown)}")
    out, ok = {}, True
    for name in (n for n in NUMBERS if n in limits):
        value, limit = numbers.get(name), float(limits[name])
        good = value is not None and np.isfinite(value) and value <= limit
        ok = ok and bool(good)
        out[name] = {"value": value, "limit": limit}
    return ok, out
