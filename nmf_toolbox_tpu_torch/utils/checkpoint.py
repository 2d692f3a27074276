"""Factor checkpoint/resume (PyTorch counterpart of
``nmf_toolbox_tpu/utils/checkpoint.py``).

Every solver accepts ``W_init``/``H_init`` (+ P/G/S/Z) and ``*_fixed``
switches, so resume is re-calling the solver with the last factors.  This
module saves a solver Result (or any dict of factor arrays or tensors) to
one ``.npz`` file and restores it as a kwargs dict ready to splat back
into the solver.

    res = nt.nmf(V, 20, maxiter=50)
    save_factors("ckpt.npz", res)
    ...
    res2 = nt.nmf(V, 20, maxiter=50, **load_factors("ckpt.npz"))

The file format is the JAX package's: one array per factor, or
``name__len`` plus ``name__0``, ``name__1``, ... for a per-source list;
``__fields__`` and ``__n_iters__`` for a Result; ``extra__*`` for the
caller's entries (``run_checkpointed`` writes ``extra__iters_done``,
``extra__cost_so_far`` and ``extra__resume_*``).  A file written by
either package loads in the other.
"""
from __future__ import annotations

import os

import numpy as np

from ..core import Result, is_dtensor, resolve_device, to_host
from ..interop import factors_from_numpy, resume_state_from_numpy
from ..parallel.collectives import dtensor_whole
from ..parallel.mesh import check_mesh

_FACTOR_KEYS = ("W", "H", "P", "G", "S", "Z")


def _host(x):
    """A checkpoint entry as NumPy: a restored DTensor whole, a per-source
    list entry by entry."""
    if isinstance(x, (list, tuple)):
        return [_host(v) for v in x]
    return to_host(dtensor_whole(x) if is_dtensor(x) else x)


def save_factors(path, result_or_dict, extra: dict | None = None) -> None:
    """Persist a Result's factors (and cost trace) to ``path`` (.npz).
    Every field is brought to the host first: tensors on the card,
    per-source lists of them and ``extra`` entries included."""
    payload = {}
    obj = result_or_dict
    if hasattr(obj, "fields"):  # core.Result
        items = {f: getattr(obj, f) for f in obj.fields}
        payload["__fields__"] = np.asarray(list(obj.fields))
        payload["__n_iters__"] = np.asarray(int(obj.n_iters))
    else:
        items = dict(obj)
    for name, val in items.items():
        if val is None:
            continue
        if isinstance(val, (list, tuple)):  # multi-source factors
            payload[f"{name}__len"] = np.asarray(len(val))
            for s, v in enumerate(val):
                payload[f"{name}__{s}"] = to_host(v)
        else:
            payload[name] = to_host(val)
    for kk, vv in (extra or {}).items():
        payload[f"extra__{kk}"] = to_host(vv)
    np.savez(path, **payload)


def load_factors(path, as_inits: bool = True) -> dict:
    """Load a checkpoint as NumPy.  With ``as_inits`` (default) factor
    arrays are returned under their ``*_init`` kwarg names so the dict can
    be passed straight back into a solver; cost/aux entries are dropped."""
    with np.load(path, allow_pickle=False) as z:
        raw: dict = {}
        lens = {k[: -len("__len")]: int(z[k]) for k in z.files
                if k.endswith("__len")}
        for name, count in lens.items():
            raw[name] = [z[f"{name}__{s}"] for s in range(count)]
        for k in z.files:
            if k.startswith("extra__"):
                raw[k] = z[k]
                continue
            if ("__" in k) or k in raw:  # per-source parts + metadata
                continue
            raw[k] = z[k]
    if not as_inits:
        return raw
    return {f"{name}_init": raw[name] for name in _FACTOR_KEYS if name in raw}


def run_checkpointed(solver, V, *args, total_iters: int, chunk: int,
                     path, resume: bool = True, backend: str = "auto",
                     **config):
    """Long-run driver: execute ``solver`` in chunks of ``chunk``
    iterations, persisting the factors after every chunk so a crashed run
    resumes where it left off.

    Within one call, a chunk's factors and ``resume_state`` go straight
    into the next chunk as tensors on the run's device; only the save
    brings them to the host.  A run resumed from ``path`` reads the
    factors as NumPy inits and turns the saved ``resume_state`` back into
    the solver's form (``interop.resume_state_from_numpy``).  For the
    memoryless MU solvers the restart state is the continuation state;
    nmfsc's and cnmfsc's step sizes and extrapolated HALS's momentum ride
    in ``resume_state``, so their chunked runs are bit-identical to one
    call.

    The tolerance rule is also evaluated on the host across chunk
    boundaries, so early stopping behaves with any chunk size.  Returns
    the final Result with the concatenated cost trace under ``.cost`` and
    the total executed iterations under ``.n_iters``; returns the
    checkpointed state as-is if the run is already complete.

    ``backend``: ``"npz"`` (one host file; on a mesh rank 0 writes it),
    ``"orbax"`` (a directory checkpoint, utils/checkpoint_orbax.py: every
    rank of a mesh run writes its own blocks and a resume restores them
    into the solver's placement), or ``"auto"`` (default): orbax when the
    run is sharded (``mesh=``) and the path has no ``.npz`` suffix, npz
    otherwise.  On a mesh every rank calls ``run_checkpointed`` with the
    same arguments.
    """
    mesh = check_mesh(config.get("mesh"))
    if backend == "auto":
        backend = ("orbax" if mesh is not None
                   and not os.fspath(path).endswith(".npz") else "npz")
    if backend == "orbax":
        from .checkpoint_orbax import load_factors_orbax, save_factors_orbax
        sname = getattr(solver, "__name__", None)

        def _load(p, as_inits=False):
            return load_factors_orbax(p, as_inits, mesh=mesh, solver=sname)

        def _save(p, res, extra):
            save_factors_orbax(p, res, extra, mesh=mesh, solver=sname)
        exists = os.path.isdir(os.fspath(path))
    elif backend == "npz":
        _load = load_factors

        def _save(p, res, extra):
            import torch.distributed as dist
            if mesh is None:
                save_factors(p, res, extra=extra)
                return
            if dist.get_rank() == 0:  # every rank holds the same factors
                save_factors(p, res, extra=extra)
            dist.barrier()
        exists = os.path.exists(os.fspath(path))
    else:
        raise ValueError(f"unknown checkpoint backend {backend!r}")

    tolerance = float(config.get("tolerance", 1e-3))
    done = 0
    inits: dict = {}
    costs = []
    resume_state = None
    device = resolve_device(V, config.get("device"), mesh)
    if resume and exists:
        raw = _load(path, as_inits=False)
        inits = {f"{k}_init": v for k, v in raw.items() if k in _FACTOR_KEYS}
        done = int(raw.get("extra__iters_done", 0))
        if "extra__cost_so_far" in raw:
            costs = [np.asarray(raw["extra__cost_so_far"])]
        rs = {k[len("extra__resume_"):]: raw[k] for k in raw
              if k.startswith("extra__resume_")}
        if rs:
            resume_state = resume_state_from_numpy(
                rs, device=device, dtype=config.get("dtype"))
    res = None
    converged = False
    while done < total_iters and not converged:
        step = min(chunk, total_iters - done)
        cfg = dict(config)
        cfg.update(inits)
        if inits:
            # factors restored from the checkpoint supersede any seeding
            # choice; solvers reject init='nndsvd*' alongside W_init
            cfg.pop("init", None)
        if resume_state is not None:
            cfg["resume_state"] = resume_state
        res = solver(V, *args, maxiter=step, **cfg)
        done += int(res.n_iters) if res.n_iters else step
        chunk_cost = to_host(res.cost)
        if costs and len(chunk_cost) and len(costs[-1]):
            prev_last = costs[-1][-1]
            # Offset-trace solvers (nmfsc/cnmfsc/chcnmf) re-store the
            # boundary cost as their initial entry; those traces have
            # length n_iters+1.  Gate the duplicate-drop on that trace
            # shape AND value equality, so a genuine bit-identical
            # plateau in a length-n_iters solver is never swallowed.
            # Equality is to rounding: a file the JAX package wrote holds
            # its own evaluation of the boundary cost.
            offset_trace = len(chunk_cost) == int(res.n_iters) + 1
            same_cost = 64 * np.finfo(chunk_cost.dtype).eps * abs(prev_last)
            if offset_trace and abs(chunk_cost[0] - prev_last) <= same_cost:
                chunk_cost = chunk_cost[1:]
            # host-side boundary convergence check (the solver's loop
            # only compares within its own chunk)
            if (len(chunk_cost) and chunk_cost[0] < prev_last
                    and prev_last - chunk_cost[0] < tolerance):
                converged = True
        costs.append(chunk_cost)
        inits = {f"{k}_init": getattr(res, k) for k in _FACTOR_KEYS
                 if getattr(res, k, None) is not None}
        resume_state = getattr(res, "resume_state", None)
        converged = converged or bool(res.converged)
        extra = {"iters_done": done, "cost_so_far": np.concatenate(costs)}
        if resume_state is not None:
            extra.update({f"resume_{k}": v for k, v in resume_state.items()})
        _save(path, res, extra)
    if res is None:
        # Already complete at entry: rebuild a Result from the checkpoint,
        # its factors as tensors on the run's device, as a solver returns.
        raw = _load(path, as_inits=False)
        names = tuple(k for k in _FACTOR_KEYS if k in raw)
        tensors = factors_from_numpy({k: _host(raw[k]) for k in names},
                                     fields=names, device=device)
        res = Result(fields=names + ("cost",), **dict(zip(names, tensors)))
        res.converged = True
    res.cost = np.concatenate(costs) if costs else to_host(res.cost)
    res.n_iters = done
    res.converged = bool(res.converged) or converged
    return res
