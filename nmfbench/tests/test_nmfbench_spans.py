"""CPU tests of nmfbench/spans.py: the port's spans read from a profiled
solve's trace, on hand-made events and on a CPU solve's own trace
(run: python -m pytest nmfbench/tests -q)."""
from __future__ import annotations

import json

import numpy as np
import pytest

import nmf_toolbox_tpu_torch as nt
from nmfbench import spans

HOST, OTHER, DEVICE = (1, 1), (1, 2), (0, 7)  # (pid, tid)


def _x(cat, name, ts, dur, where, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": where[0], "tid": where[1]}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def span(name, ts, dur):
    return _x("user_annotation", name, ts, dur, HOST)


def launch(corr, ts, thread=HOST):
    return _x("cuda_runtime", "cudaLaunchKernel", ts, 2, thread, corr)


def kernel(name, corr, ts, dur, cat="kernel"):
    return _x(cat, name, ts, dur, DEVICE, corr)


def solve_events():
    """One solve of two iterations, times in microseconds, every op after
    its launch:

    nmf.solve 0-1000: an entry launch at 10; loop.run 98-705 holding
    loop.iter 100-400 (a launch at 110, loop.cost 200-270 holding a
    launch at 210 and a collectives.reduce 220-250 with NCCL's launch at
    230, loop.read 280-400 with its copy at 285) and loop.iter 420-700 (a
    launch at 450, loop.cost 610-635 with a launch at 615, loop.read
    640-700 with a copy at 642); a launch at 800.  Outside it: a launch
    of another thread at 230, and one at 1050 after the solve.
    """
    return [
        span("nmf.solve", 0, 1000), span("loop.run", 98, 607), span("loop.iter", 100, 300),
        span("loop.cost", 200, 70), span("collectives.reduce", 220, 30),
        span("loop.read", 280, 120), span("loop.iter", 420, 280),
        span("loop.cost", 610, 25), span("loop.read", 640, 60),
        span("aten::mm", 120, 5),  # not a span of the port
        launch(1, 10), launch(2, 110), launch(3, 210), launch(4, 230), launch(5, 285),
        launch(6, 450), launch(7, 615), launch(8, 642), launch(9, 800),
        launch(10, 230, OTHER), launch(11, 1050),
        kernel("normalize", 1, 20, 20), kernel("phase", 2, 150, 100),
        kernel("cost", 3, 250, 40), kernel("ncclDevKernel_AllReduce", 4, 290, 10),
        kernel("Memcpy DtoH", 5, 300, 5, cat="gpu_memcpy"), kernel("phase", 6, 500, 100),
        kernel("cost", 7, 620, 20), kernel("Memcpy DtoH", 8, 645, 5, cat="gpu_memcpy"),
        kernel("gather", 9, 810, 20), kernel("elsewhere", 10, 900, 10),
        kernel("after", 11, 1100, 10),
        # the device-side copy of a span is no device operation
        _x("gpu_user_annotation", "loop.iter", 150, 150, DEVICE),
    ]


def test_ops_go_to_the_innermost_span_of_their_launch():
    r = spans.read(solve_events())
    names = [s[0] for s in r["spans"]]
    assert names == ["nmf.solve", "loop.run", "loop.iter", "loop.cost", "collectives.reduce",
                     "loop.read", "loop.iter", "loop.cost", "loop.read"]
    assert [s[3] for s in r["spans"]] == [None, 0, 1, 2, 3, 2, 1, 6, 6]
    holder = {op[2] + str(op[0]): op[3] for op in r["ops"]}
    assert holder == {"normalize20.0": 0, "phase150.0": 2, "cost250.0": 3,
                      "ncclDevKernel_AllReduce290.0": 4, "Memcpy DtoH300.0": 5,
                      "phase500.0": 6, "cost620.0": 7, "Memcpy DtoH645.0": 8,
                      "gather810.0": 0, "elsewhere900.0": None, "after1100.0": None}


def test_a_card_clock_ahead_of_its_launches_is_moved_back():
    """Every device time 300 us early, as a trace with the card's clock
    mapped wrong shows them: the second iteration's first op, launched at
    450 into an idle card, is seen at 200; every op moves back by that
    lead of 250 us, and the readings that compare host and card follow."""
    ev = solve_events()
    skewed = [dict(e, ts=e["ts"] - 300) if e["pid"] == DEVICE[0] else e for e in ev]
    r, back = spans.read(ev), spans.read(skewed)
    assert r["lead_us"] == 0.0 and back["lead_us"] == pytest.approx(250.0)
    assert [op[0] for op in back["ops"]] == pytest.approx([op[0] - 50 for op in r["ops"]])
    assert spans.init_ms(back) == pytest.approx(spans.init_ms(r) - 0.050)
    assert spans.cost_pct(back) == pytest.approx(spans.cost_pct(r))


def _drifting_solve(drift):
    """Three iterations of 30 ms, each a read at its end and a first op
    launched 100 us after its start that runs 10 us after its launch, and
    one op in the middle of the second; the card's times seen early by
    ``drift`` x their time."""
    ev, corr = [span("nmf.solve", 0, 95_000), span("loop.run", 1, 93_000)], 0
    for k in range(3):
        t = 1000 + 30_000 * k
        corr += 1
        ev += [span("loop.iter", t, 29_000), span("loop.read", t + 20_000, 9_000),
               launch(corr, t + 100), kernel("first", corr, t + 110, 5_000)]
    ev += [launch(99, 32_000), kernel("middle", 99, 45_000, 10)]
    return [dict(e, ts=e["ts"] - drift * e["ts"]) if e["pid"] == DEVICE[0] else e for e in ev]


def test_a_drifting_card_clock_is_moved_back_by_the_lead_near_each_op():
    """The lead, seen at each idle-card launch after a read, is
    interpolated between them: the op in the middle lands within the
    launch latency of where it ran, and a trace without drift moves
    nothing."""
    r = spans.read(_drifting_solve(1e-3))
    got = {op[2] + str(k): op[0] for k, op in enumerate(r["ops"])}
    assert got["middle3"] == pytest.approx(45_000, abs=11)
    assert got["first2"] == pytest.approx(61_110, abs=11)
    assert r["lead_us"] == pytest.approx(61.11 - 10, abs=0.1)
    plain = spans.read(_drifting_solve(0.0))
    assert plain["lead_us"] == 0.0
    assert [op[0] for op in plain["ops"]] == [1110.0, 31_110.0, 61_110.0, 45_000.0]


def test_the_four_readings_on_a_hand_made_trace():
    r = spans.read(solve_events())
    # the first op launched inside the first loop.iter starts at 150
    assert spans.init_ms(r) == pytest.approx(0.150)
    # busy: 20 + [150, 305] + 100 + 20 + 5 + 20 + 10 + 10 = 340 us;
    # loop.cost: the cost kernels (40, 20) and the NCCL kernel (10) inside it
    assert spans.cost_pct(r) == pytest.approx(100.0 * 70 / 340)
    # read 1: 280 to the next iteration's first op at 500, less [280, 305];
    # read 2: 640 to the solve's end at 1000, less [645, 650], [810, 830],
    # [900, 910]
    assert spans.check_gap_ms(r) == pytest.approx((195 + 325) * 1e-3 / 2)
    assert spans.collective_seconds(r) == pytest.approx([10e-6])


def test_the_entrys_collectives_are_left_out():
    """A reduce in the entry, before loop.run, holds the ranks' start
    skew: its NCCL kernel is no collective of the loop."""
    ev = solve_events() + [span("collectives.reduce", 30, 20), launch(12, 35),
                           kernel("ncclDevKernel_AllReduce", 12, 60, 30_000)]
    r = spans.read(ev)
    assert [s[0] for s in r["spans"]].count("collectives.reduce") == 2
    assert spans.collective_seconds(r) == pytest.approx([10e-6])


def test_collective_wait_counts_the_ranks_that_arrive_early():
    """Rank 2 arrives last at every collective: its NCCL kernel is the
    transfer alone; the others' run longer by the time they wait."""
    transfer, early = [4e-6, 6e-6, 5e-6], [[3e-6, 0.0, 1e-6], [1e-6, 2e-6, 0.0]]
    per_rank = [[t + w for t, w in zip(transfer, waits)] for waits in early] + [transfer]
    total = 3 * sum(transfer) + sum(map(sum, early))
    assert spans.collective_wait_pct(per_rank) == pytest.approx(
        100.0 * sum(map(sum, early)) / total)
    assert spans.collective_wait_pct([transfer] * 4) == 0.0
    # a rank's wait an iteration, over 2 iterations: 7 us over 3 ranks
    assert spans.collective_wait_ms(per_rank, 2) == pytest.approx(7e-3 / 3 / 2)


@pytest.mark.parametrize("per_rank", [
    [[1e-6, 2e-6]],                    # one chip
    [[1e-6, 2e-6], [1e-6]],            # the ranks' counts differ
    [[0.0, 0.0], [0.0, 0.0]],          # no NCCL kernel (Gloo on the CPU)
    [[], []],                          # no collective span
])
def test_collective_wait_reads_nothing(per_rank):
    assert spans.collective_wait_pct(per_rank) is None
    assert spans.collective_wait_ms(per_rank, 2) is None


def test_no_span_or_no_device_op_reads_nothing():
    """A program without the spans, and a CPU trace without device ops."""
    ev = solve_events()
    bare = spans.read([e for e in ev if e["cat"] != "user_annotation"])
    cpu = spans.read([e for e in ev if e["pid"] != DEVICE[0]])
    for r in (bare, cpu):
        assert spans.init_ms(r) is None and spans.check_gap_ms(r) is None
        assert spans.cost_pct(r) is None
    assert spans.collective_seconds(bare) == []
    assert spans.collective_wait_pct([spans.collective_seconds(cpu)] * 2) is None


def test_a_cpu_solve_trace(tmp_path):
    """The spans of a real profiled CPU solve, exported as utils.debug's
    profile_to writes them: every span read, no device op, no reading;
    main prints the readings of the files."""
    from nmf_toolbox_tpu_torch.utils import debug
    rng = np.random.default_rng(0)
    V = (rng.gamma(2.0, 1.0, (20, 3)) @ rng.gamma(0.5, 1.0, (3, 30)) + 0.01).astype(np.float32)
    with debug.profile_to(str(tmp_path)):
        res = nt.nmf(V, 3, divergence="kl", maxiter=6, tolerance=1e-9, seed=1, device="cpu")
    (path,) = tmp_path.glob("trace_*.json")
    r = spans.read(json.loads(path.read_text())["traceEvents"])
    names = [s[0] for s in r["spans"]]
    assert names.count("nmf.solve") == names.count("loop.run") == 1
    assert names.count("loop.iter") == res.n_iters
    assert names.count("loop.cost") == res.n_iters and r["ops"] == []
    assert spans.readings([json.loads(path.read_text())["traceEvents"]])["cost_pct"] is None
    assert spans.main([str(path)]) == 0

