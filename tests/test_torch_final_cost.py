"""Port's ``Result.final_cost`` against the JAX package's.

Runs on the CPU in f64 with the same injected inits in both packages
(their seeded default inits draw different numbers), one run that stops
on its tolerance and one that runs out of ``maxiter``; the values agree
to the goldens' 1e-9 relative (tests/test_goldens.py).  The trace rules
(offset, zero-padded, 2-D batched) are checked on hand-built Results of
both packages.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import nmf_toolbox_tpu as jt  # noqa: E402
from nmf_toolbox_tpu import core as jcore  # noqa: E402
import nmf_toolbox_tpu_torch as tt  # noqa: E402
from nmf_toolbox_tpu_torch import core as tcore  # noqa: E402

RTOL = 1e-9  # the goldens' tolerance, f64
CPU = {"device": "cpu"}


def _problem(seed, m=40, n=30, k=4):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.1, 1.0, (m, n)), rng.uniform(0.1, 1.0, (m, k)),
            rng.uniform(0.1, 1.0, (k, n)))


# (solver, extra config, maxiter, tolerance): a tolerance of 1e-2 stops
# these runs within maxiter, 1e-30 never does.
RUNS = [(name, extra, maxiter, tol)
        for name, extra in (("nmf", {"divergence": "kl"}),
                            ("nmf", {"divergence": "euclidean"}),
                            ("nmf_hals", {}))
        for maxiter, tol in ((300, 1e-2), (12, 1e-30))]


@pytest.mark.parametrize("name,extra,maxiter,tol", RUNS)
def test_final_cost_matches_jax(name, extra, maxiter, tol):
    V, W0, H0 = _problem(seed=len(name) + maxiter)
    kw = dict(W_init=W0, H_init=H0, maxiter=maxiter, tolerance=tol,
              dtype=np.float64, **extra)
    j = getattr(jt, name)(V, 4, **kw)
    t = getattr(tt, name)(V, 4, **kw, **CPU)
    assert t.n_iters == j.n_iters
    assert (t.n_iters < maxiter) == (tol > 1e-10)  # one stops early, one runs out
    assert isinstance(t.final_cost, float)
    assert t.final_cost == pytest.approx(j.final_cost, rel=RTOL, abs=0)
    assert t.final_cost == pytest.approx(float(np.asarray(t.cost)[-1]), rel=0, abs=0)


# (cost, n_iters, expected): trimmed, initial-cost offset (n_iters + 1),
# lnmf's untrimmed trace zero-padded past n_iters, no iterations, and a
# (B, iters) batched trace (the min of the last column).
RULES = [
    ([5.0, 4.0, 3.0], 3, 3.0),
    ([9.0, 5.0, 4.0, 3.0], 3, 3.0),
    ([5.0, 4.0, 3.0, 0.0, 0.0, 0.0], 3, 3.0),
    ([7.0], 0, 7.0),
    ([[5.0, 4.0, 3.5], [6.0, 3.0, 2.5], [4.0, 3.9, 3.8]], 3, 2.5),
]


@pytest.mark.parametrize("cost,n_iters,expected", RULES)
def test_final_cost_trace_rules(cost, n_iters, expected):
    for core in (tcore, jcore):
        r = core.Result(fields=("W", "H", "cost"), cost=np.asarray(cost),
                        n_iters=n_iters)
        assert isinstance(r.final_cost, float)
        assert r.final_cost == expected
