"""The port's spans (``core.span``): free with no profiler, and under
``torch.profiler`` one ``nmf.solve`` a call, one ``loop.run`` inside it,
one ``loop.iter`` an iteration inside that, one ``loop.read`` a host read
of the loop, one ``loop.cost`` a computed objective, and the same
``collectives.*`` spans on every rank of a mesh.  The factors and the
cost do not depend on whether a profiler records."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import nmf_toolbox_tpu_torch as tt  # noqa: E402
from nmf_toolbox_tpu_torch import core  # noqa: E402
from nmf_toolbox_tpu_torch.ops import loop  # noqa: E402
from nmf_toolbox_tpu_torch.utils import debug  # noqa: E402

from torch_mesh import Ranks, collective_spans, profiled_spans  # noqa: E402

METHODS = [("gram", "euclidean"), ("naive", "kl"), ("fused", "kl")]
MAXITER = 30
SPANS = {"nmf.solve", "loop.run", "loop.iter", "loop.read", "loop.cost"}


def problem(seed=0):
    rng = np.random.default_rng(seed)
    V = rng.gamma(2.0, 1.0, (24, 4)) @ rng.gamma(0.5, 1.0, (4, 36)) + 0.01
    return V.astype(np.float32)


def solve(method, div, cost_every=1, V=None):
    return tt.nmf(problem() if V is None else V, 4, divergence=div, method=method,
                  maxiter=MAXITER, tolerance=1e-7, seed=1, device="cpu",
                  cost_every=cost_every)


@pytest.fixture
def record_calls(monkeypatch):
    """The names ``record_function`` entered while the fixture holds."""
    entered = []
    real = torch.ops.profiler._record_function_enter_new

    def counting(name, *args):
        entered.append(name)
        return real(name, *args)
    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new", counting)
    return entered


@pytest.mark.parametrize("method,div", METHODS)
def test_no_profiler_enters_no_record_function(record_calls, method, div):
    solve(method, div)
    assert record_calls == []
    profiled_spans(lambda: solve(method, div))  # the count sees a recording one
    assert SPANS <= set(record_calls)


def test_span_off_is_one_shared_null_context():
    assert core.span("nmf.solve") is core.span("loop.iter")
    assert debug.trace is core.span


def test_span_follows_the_profilers_own_state(monkeypatch):
    """The spans read the profiler's state itself, not the Python copy
    in ``torch.autograd.profiler`` that the exit of any profiler clears:
    with that copy false under a recording profiler a span records, and
    with it true and no profiler it records nothing."""
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled", True)
    assert core.span("x") is core.span("y")

    def inside():
        monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled", False)
        with core.span("x"):
            pass
    _, spans = profiled_spans(inside)
    assert [n for n, _, _ in spans] == ["x"]


def _within(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.mark.parametrize("cost_every", [1, 4])
@pytest.mark.parametrize("method,div", METHODS)
def test_a_solve_records_its_spans(method, div, cost_every):
    reads = core.host_reads
    res, spans = profiled_spans(lambda: solve(method, div, cost_every))
    reads = core.host_reads - reads
    by = {name: [s for s in spans if s[0] == name] for name in SPANS}
    assert {s[0] for s in spans} == SPANS
    (outer,) = by["nmf.solve"]
    (loop_run,) = by["loop.run"]
    iters = by["loop.iter"]
    assert len(iters) == res.n_iters > 1
    assert _within(loop_run, outer) and all(_within(s, loop_run) for s in iters)
    assert len(by["loop.read"]) == reads
    checks = sum(loop.is_check(i, cost_every, MAXITER) for i in range(res.n_iters))
    assert len(by["loop.cost"]) == checks
    if cost_every > 1:
        assert checks < res.n_iters
    for name in ("loop.read", "loop.cost"):
        assert all(any(_within(s, it) for it in iters) for s in by[name])


@pytest.mark.parametrize("method,div", METHODS)
def test_the_profiler_changes_no_result(method, div):
    off = solve(method, div)
    on, _ = profiled_spans(lambda: solve(method, div))
    assert on.n_iters == off.n_iters
    for f in ("W", "H", "cost"):
        np.testing.assert_array_equal(np.asarray(getattr(on, f)), np.asarray(getattr(off, f)))


@pytest.fixture(scope="module")
def ranks():
    r = Ranks(2)
    yield r
    r.close()


@pytest.mark.parametrize("method,div", METHODS)
def test_mesh_ranks_record_the_same_collective_spans(ranks, method, div):
    got = ranks.run(collective_spans, "nmf_toolbox_tpu_torch.nmf", problem(), 4,
                    mesh="1d", divergence=div, method=method, maxiter=8, seed=1,
                    tolerance=1e-7)
    (names0, calls0), (names1, calls1) = got
    assert names0 == names1 and calls0 == calls1 == len(names0) > 0
    assert set(names0) == {"collectives.reduce", "collectives.gather"}
