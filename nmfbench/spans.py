"""The port's spans in a profiled solve's trace, and what they measure.

The port records seven spans (``nmf_toolbox_tpu_torch.core.span``) while a
profiler records: ``nmf.solve`` (one call of ``nmf``), ``loop.run`` (the
loop of ``ops/loop.run``), ``loop.iter`` (one of its iterations),
``loop.read`` (the loop's host read),
``loop.cost`` (an objective computed on a check iteration),
``collectives.reduce`` and ``collectives.gather`` (one ``all_reduce`` or
``all_gather`` of a mesh).  They are ``record_function`` ranges, on the
clock of the card's events, so :func:`read` can give each device
operation to the innermost span that launched it: the span that holds
the host's ``cuda_runtime`` / ``cuda_driver`` call with the operation's
``correlation``, on the same thread.

From one rank's reading:

* :func:`init_ms`: the start of the first ``nmf.solve`` to the start of
  the first device operation launched inside its first ``loop.iter``
  (the entry's host and device work: config, inits, placement, W0's unit
  columns, the step's constants);
* :func:`check_gap_ms`: the device's idle time from the start of each
  ``loop.read`` to the first operation the next ``loop.iter`` launches
  (or the end of the solve), summed, over the solve's iterations;
* :func:`cost_pct`: the device seconds of the operations launched inside
  ``loop.cost``, over the busy seconds (the union of every operation).

From every rank's :func:`collective_seconds`, the collectives of the
loop: :func:`collective_wait_pct`, the share of the NCCL kernels' seconds
spent waiting for the last rank to arrive, and :func:`collective_wait_ms`,
a rank's wait an iteration, with no clock shared between the ranks.

Each returns None where the trace gives nothing to read: no span of the
port (a program without them), no device operation (the CPU).

    python3 -m nmfbench.spans TRACE.json [TRACE_RANK1.json ...]

prints these readings of Chrome traces exported by ``torch.profiler``
(``utils.debug.profile_to`` writes one; ``.json.gz`` is read too), rank
0's first.
"""
from __future__ import annotations

import gzip
import json
import sys

import numpy as np

from .timing import DEVICE_CATS, _union

NAMES = ("nmf.solve", "loop.run", "loop.iter", "loop.read", "loop.cost",
         "collectives.reduce", "collectives.gather")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def read(events) -> dict:
    """The port's spans and the device's operations of a Chrome trace's
    events (times in microseconds):

    * ``spans``: ``[name, start, end, parent]`` in the order they start,
      ``parent`` the index of the span that holds it on its thread;
    * ``ops``: ``[start, end, name, span]``, ``span`` the index of the
      innermost span that holds the operation's launch (None: outside
      them, or a launch the trace does not show);
    * ``lead_us``: how far the trace put an operation before its own
      launch (0 where its clocks agree); the ops' times are moved later
      by :func:`_lead`.
    """
    spans, ops, launches = [], [], {}
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s, d, cat = float(e["ts"]), float(e["dur"]), e.get("cat")
        thread = (e.get("pid"), e.get("tid"))
        corr = (e.get("args") or {}).get("correlation")
        if cat == "user_annotation" and e.get("name") in NAMES:
            spans.append((s, s + d, e["name"], thread))
        elif cat in LAUNCH_CATS and corr is not None:
            launches[corr] = (s, thread)
        elif cat in DEVICE_CATS:
            ops.append((s, s + d, e.get("name", "?"), corr))
    spans.sort(key=lambda x: (x[0], -x[1]))
    points = {}  # thread -> [(time, 0, span index) or (time, 1, op index)]
    for i, (s, _, _, thread) in enumerate(spans):
        points.setdefault(thread, []).append((s, 0, i))
    for j, (_, _, _, corr) in enumerate(ops):
        if corr in launches:
            t, thread = launches[corr]
            points.setdefault(thread, []).append((t, 1, j))
    parent, holder = [None] * len(spans), [None] * len(ops)
    for pts in points.values():
        stack = []
        for t, kind, idx in sorted(pts):
            # a span that has ended holds nothing later; one that ends
            # as another starts is its sibling
            while stack and (spans[stack[-1]][1] < t
                             or (kind == 0 and spans[stack[-1]][1] == t)):
                stack.pop()
            top = stack[-1] if stack else None
            if kind == 0:
                parent[idx] = top
                stack.append(idx)
            else:
                holder[idx] = top
    r = {"spans": [[n, s, e, p] for (s, e, n, _), p in zip(spans, parent)],
         "ops": [[s, e, n, h] for (s, e, n, _), h in zip(ops, holder)]}
    xs, leads = _lead(r, [launches[c][0] if c in launches else None for *_, c in ops])
    for op in r["ops"]:
        shift = max(0.0, float(np.interp(op[0], xs, leads))) if xs else 0.0
        op[0], op[1] = op[0] + shift, op[1] + shift
    r["lead_us"] = max([0.0, *leads])
    return r


def _lead(r, launched):
    """No operation starts before its own launch, and the first one that
    a ``loop.iter`` after a ``loop.read`` launches finds the card idle, so
    it starts a few microseconds after its launch.  Some traces map the
    card's clock onto the host's wrong (seen on an H100's host: ops up to
    0.1-5 ms before their launches, the lead drifting by ~0.5 us a ms).
    Returns those first ops' device starts and their leads (launch less
    start), in time order; :func:`read` moves each op later by the lead
    interpolated at its start, where it is above 0.  Those first ops then
    start at their launches, up to one launch latency (15-55 us on an
    H100) before they ran; :func:`check_gap_ms` hardly moves (both ends
    of its gaps are device times), :func:`init_ms` does."""
    pts = sorted({(r["ops"][j][0], launched[j] - r["ops"][j][0])
                  for _, j in _after_reads(r) if j is not None})
    return [x for x, _ in pts], [y for _, y in pts]


def _inside(r, idx, outer) -> bool:
    """Whether span ``idx`` is span ``outer`` or lies inside it."""
    while idx is not None:
        if idx == outer:
            return True
        idx = r["spans"][idx][3]
    return False


def _enclosing(r, idx, prefix):
    """The innermost span, ``idx`` or one holding it, whose name starts
    with ``prefix``; None if there is none."""
    while idx is not None and not r["spans"][idx][0].startswith(prefix):
        idx = r["spans"][idx][3]
    return idx


def _solve(r):
    """The index of the first ``nmf.solve``, and its ``loop.iter`` spans."""
    solves = [i for i, sp in enumerate(r["spans"]) if sp[0] == "nmf.solve"]
    if not solves or not r["ops"]:
        return None, []
    first = solves[0]
    return first, [i for i, sp in enumerate(r["spans"])
                   if sp[0] == "loop.iter" and _inside(r, i, first)]


def _first_ops(r) -> dict:
    """The index of the first device operation launched inside each
    ``loop.iter`` (by its start), by the span's index."""
    out = {}
    for j, op in enumerate(r["ops"]):
        i = _enclosing(r, op[3], "loop.iter")
        if i is not None and (i not in out or op[0] < r["ops"][out[i]][0]):
            out[i] = j
    return out


def _after_reads(r) -> list:
    """Each ``loop.read``'s index, with the index of the first device
    operation that the next ``loop.iter`` launched (None: none did)."""
    firsts = _first_ops(r)
    starts = sorted((r["spans"][i][1], j) for i, j in firsts.items())
    out = []
    for k, sp in enumerate(r["spans"]):
        if sp[0] == "loop.read":
            out.append((k, next((j for t, j in starts if t >= sp[2]), None)))
    return out


def init_ms(r):
    solve, iters = _solve(r)
    first = _first_ops(r).get(iters[0]) if iters else None
    return None if first is None else (r["ops"][first][0] - r["spans"][solve][1]) * 1e-3


def _idle(busy, lo, hi) -> float:
    """Microseconds of [lo, hi] that the merged intervals ``busy`` leave."""
    covered = sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in busy)
    return max(0.0, hi - lo - covered)


def check_gap_ms(r):
    solve, iters = _solve(r)
    if solve is None or not iters:
        return None
    busy = _union((op[0], op[1]) for op in r["ops"])
    end = r["spans"][solve][2]
    total = sum(_idle(busy, r["spans"][k][1], end if j is None else r["ops"][j][0])
                for k, j in _after_reads(r) if _inside(r, k, solve))
    return total * 1e-3 / len(iters)


def cost_pct(r):
    solve, _ = _solve(r)
    busy = sum(e - s for s, e in _union((op[0], op[1]) for op in r["ops"]))
    if solve is None or busy <= 0:
        return None
    spent = sum(op[1] - op[0] for op in r["ops"]
                if _enclosing(r, op[3], "loop.cost") is not None)
    return 100.0 * spent / busy


def collective_seconds(r) -> list:
    """The seconds of the NCCL kernels launched inside each
    ``collectives.*`` span of ``loop.run``, in the order the spans start.
    The entry's collectives are left out: the first of them waits for
    the ranks to start the solve, as far apart as their set-up left them
    (on four H100s, 0.09-1.3 s summed over the ranks where the solve
    follows a broadcast), which says nothing of the loop."""
    at = {i: 0.0 for i, sp in enumerate(r["spans"])
          if sp[0].startswith("collectives.") and _enclosing(r, sp[3], "loop.run") is not None}
    for s, e, name, idx in r["ops"]:
        idx = _enclosing(r, idx, "collectives.")
        if idx in at and "nccl" in name.lower():
            at[idx] += (e - s) * 1e-6
    return [at[i] for i in sorted(at)]


def _wait(per_rank):
    """For the j-th collective, each rank's NCCL seconds less the least
    over the ranks (the last to arrive waits for no one), summed over j
    and the ranks, and the sum of their NCCL seconds; ``per_rank`` holds
    each rank's :func:`collective_seconds`.  None on one rank, where the
    ranks' counts differ, or with no NCCL kernel."""
    if len(per_rank) < 2 or len({len(s) for s in per_rank}) != 1:
        return None
    total = sum(map(sum, per_rank))
    if total <= 0:
        return None
    return sum(sum(ts) - len(ts) * min(ts) for ts in zip(*per_rank)), total


def collective_wait_pct(per_rank):
    """The share of the NCCL seconds spent waiting (:func:`_wait`)."""
    w = _wait(per_rank)
    return None if w is None else 100.0 * w[0] / w[1]


def collective_wait_ms(per_rank, n_iters):
    """A rank's wait (:func:`_wait`) an iteration of ``n_iters``, in ms."""
    w = _wait(per_rank)
    return None if w is None or not n_iters else w[0] * 1e3 / len(per_rank) / n_iters


def readings(traces) -> dict:
    """Every reading of the traces' events, rank 0's first."""
    rs = [read(ev) for ev in traces]
    per_rank = [collective_seconds(r) for r in rs]
    return {"init_ms": init_ms(rs[0]), "check_gap_ms": check_gap_ms(rs[0]),
            "cost_pct": cost_pct(rs[0]),
            "collective_wait_pct": collective_wait_pct(per_rank),
            "collective_wait_ms": collective_wait_ms(per_rank, len(_solve(rs[0])[1]))}


def main(paths) -> int:
    traces = []
    for path in paths:
        with (gzip.open if path.endswith(".gz") else open)(path, "rt") as f:
            traces.append(json.load(f).get("traceEvents", []))
    print(json.dumps(readings(traces)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
