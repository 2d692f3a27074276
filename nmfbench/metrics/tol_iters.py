"""Iterations a solve takes to the stop rule: ``Result.n_iters``, the mean
over the window's solves (the convergence loop, ``ops/loop.py: run``)."""
UNIT = "iter"


def read(run):
    if not run.solves:
        return None
    return run.iters / len(run.solves)
