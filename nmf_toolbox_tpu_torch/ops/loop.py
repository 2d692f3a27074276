"""Convergence-driven iteration loop (PyTorch counterpart of
``nmf_toolbox_tpu/ops/loop.py``).

Every reference solver runs ``for iter = 1:maxiter`` with the early-exit
rule (nmf.m:221-224):

  stop at iter > 1 when cost(iter) < cost(iter-1)
                    and cost(iter-1) - cost(iter) < tolerance

(lnmf.m:89 uses <= on both comparisons; nmfsc/cnmfsc additionally return
when a line-search stepsize underflows 1e-200.)

The JAX package runs the loop as one on-device ``lax.while_loop``.  Here
it is a Python loop over eager steps: the cost buffer lives on the
device, the stop rule is evaluated there in the cost dtype, and its one
boolean is read on the host only on check iterations — every iteration
at ``cost_every=1``, the cadence's check iterations otherwise — so a run
pays one host sync per check.  A run with a ``callback`` reads the cost
(and, on a check, the boolean with it) once per iteration instead.
``n_iters``, ``stopped``, ``terminated`` and the trim rules are those of
the JAX loop.

Under a profiler the loop is the span ``loop.run``, each iteration inside
it ``loop.iter``, each host read of the loop ``loop.read`` and each
objective that :func:`cost_cadence` computes ``loop.cost`` (``core.span``;
nothing is recorded otherwise).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..core import host_read, span, torch_dtype


class LoopOut(NamedTuple):
    state: object
    cost_buf: torch.Tensor  # (maxiter + offset,)
    n_iters: int            # iterations actually executed
    stopped: bool           # tolerance rule fired
    terminated: bool        # step_fn requested termination (line-search underflow)


def is_check(i: int, ce: int, maxiter: int) -> bool:
    """Iterations that compute a fresh objective under ``cost_every=ce``:
    the first, every ce-th and the last."""
    return (i + 1) % ce == 0 or i == 0 or i + 1 >= maxiter


def run(step_fn: Callable, init_state, maxiter: int, tolerance,
        *, offset: int = 0, initial_cost=None, inclusive: bool = False,
        cost_dtype=None, cost_every: int = 1,
        callback: Callable | None = None) -> LoopOut:
    """Run the MU loop.

    ``step_fn(state, i) -> (state, cost, terminate)`` performs one full
    iteration (both factor updates + cost).  ``cost`` is a 0-d tensor on
    the state's device; ``terminate`` a Python bool or 0-d bool tensor
    (read on the host every iteration when it is a tensor).

    offset=1 reserves index 0 of the cost buffer for ``initial_cost``
    (nmfsc-family semantics).  ``inclusive`` switches both comparisons of
    the stop rule to <= (lnmf.m:89).  ``cost_every`` must match the
    cadence of the step's :func:`cost_cadence` tail: when > 1 the stop
    rule is checked only on iterations that computed a fresh objective.

    ``callback(i, cost)`` (an int and a float) runs once per executed
    iteration, after the step and before the stop rule is read, as the
    JAX loop's ``jax.debug.callback`` does.  With ``cost_every > 1`` a
    non-check iteration passes the carried cost, the value its trace
    entry holds.
    """
    state0 = init_state[0] if isinstance(init_state, (tuple, list)) and init_state else init_state
    # The cost buffer lives with the state; a state with no tensor (a step
    # that carries nothing) keeps it on the host.
    device = state0.device if torch.is_tensor(state0) else torch.device("cpu")
    if cost_dtype is None:
        cost_dtype = (torch.as_tensor(initial_cost).dtype
                      if initial_cost is not None else torch.float32)
    cost_dtype = torch_dtype(cost_dtype)
    buf = torch.zeros((maxiter + offset,), dtype=cost_dtype, device=device)
    if initial_cost is not None:
        buf[0] = torch.as_tensor(initial_cost, dtype=cost_dtype)
    tol = torch.tensor(tolerance, dtype=cost_dtype, device=device)
    ce = int(cost_every)

    state, i, stopped, terminated = init_state, 0, False, False
    # ``loop.run`` holds the turn between two iterations' spans too, so that
    # no idle stretch of the card inside the loop falls outside a loop span.
    with span("loop.run"):
        while not stopped and not terminated and i < maxiter:
            with span("loop.iter"):
                state, c, term = step_fn(state, i)
                terminated = bool(_read(term) if torch.is_tensor(term) else term)
                buf[i + offset] = c
                c, trigger = buf[i + offset], None
                if i >= 1 and not terminated and is_check(i, ce, maxiter):
                    prev = buf[max(i + offset - 1, 0)]
                    if inclusive:
                        trigger = (c <= prev) & (prev - c <= tol)
                    else:
                        trigger = (c < prev) & (prev - c < tol)
                if callback is not None:
                    # One read brings the cost and, on a check, the trigger.
                    read = _read(c[None] if trigger is None
                                 else torch.stack((c, trigger.to(cost_dtype))))
                    callback(i, read[0])
                    stopped = trigger is not None and bool(read[1])
                elif trigger is not None:
                    stopped = _read(trigger)  # the one host sync of a check iteration
            i += 1
    return LoopOut(state, buf, i, stopped, terminated)


def _read(t: torch.Tensor):
    """The loop's host read, in the span ``loop.read``: the sync in which
    the card idles until the host has the value and issues the next step."""
    with span("loop.read"):
        return host_read(t)


def cadence_state(state: tuple, ce: int, dtype) -> tuple:
    """Initial carry for a ``run`` step using :func:`cost_cadence`:
    with cost_every > 1 the carry grows a trailing slot holding the last
    computed objective (+inf until the first evaluation, so no stop-rule
    comparison can fire early)."""
    if int(ce) == 1:
        return state
    return tuple(state) + (torch.tensor(float("inf"), dtype=dtype,
                                        device=state[0].device),)


def cost_cadence(ce: int, maxiter: int):
    """Build the ``finish(state, carry, i, cost_fn)`` tail for a ``run``
    step function implementing the ``cost_every`` knob.

    The objective feeds ONLY the stopping rule (nmf.m:221-224), never
    the factor updates, so with cost_every = N > 1 it is evaluated on
    iterations {1, N, 2N, ..., maxiter} and carried forward in between:
    the skipped iterations drop the objective's reconstruction and
    divergence-field pass entirely.  Carried entries repeat the last
    computed value, which can never fire the strict
    ``cost(i) < cost(i-1)`` trigger, so the stop rule degrades exactly
    to "decrease over the last N iterations < tolerance".

    ``state`` is the updated factor tuple, ``carry`` the incoming loop
    carry (whose trailing slot is the last computed objective when
    ce > 1), ``cost_fn()`` the objective of the updated state.  Returns
    the ``(new_carry, cost, terminate)`` triple ``run`` expects.
    """
    ce = int(ce)

    def cost(cost_fn):
        with span("loop.cost"):  # the objective, whatever computes it
            return cost_fn()

    def finish(state, carry, i, cost_fn):
        if ce == 1:
            return tuple(state), cost(cost_fn), False
        cp = carry[-1]
        c = cost(cost_fn).to(cp.dtype) if is_check(i, ce, maxiter) else cp
        return tuple(state) + (c,), c, False

    return finish


def trim_cost(out: LoopOut, maxiter: int, *, offset: int = 0,
              trim: bool = True) -> np.ndarray:
    """Host-side cost-vector trimming matching each solver's semantics.

    Returns a NumPy array.
    - standard solvers (offset=0): trimmed to n_iters on early stop
      (nmf.m:221-224); full length if the loop ran out.
    - lnmf: pass trim=False — the reference breaks without trimming, so the
      vector keeps length maxiter with zeros after the stop (lnmf.m:89-91).
    - nmfsc family (offset=1): tolerance stop -> first n_iters+1 entries
      (initial cost + each iteration, nmfsc.m:241-243); line-search
      underflow at iteration i -> first i entries only (nmfsc.m:170-174).
    """
    buf = out.cost_buf.detach().cpu().numpy()
    n = int(out.n_iters)
    if not trim:
        return buf
    if out.terminated:
        return buf[: n - 1 + offset]
    if out.stopped:
        return buf[: n + offset]
    return buf
