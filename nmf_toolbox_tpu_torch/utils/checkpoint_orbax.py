"""Directory checkpoints of sharded runs (PyTorch counterpart of
``nmf_toolbox_tpu/utils/checkpoint_orbax.py``), on
``torch.distributed.checkpoint`` (DCP).

The npz backend (checkpoint.py) writes one host file, which on a
sharded run means every rank writes the same gathered factors.  This
backend keeps the JAX package's names and contract:

- **Per-shard writes.** With ``mesh=`` and ``solver=`` each factor is
  wrapped as a ``DTensor`` with the solver's placement
  (``parallel.placements_for``): every rank writes only its own block,
  and nothing is gathered for the save.
- **Sharded restore.** ``load_factors_orbax(..., mesh=, solver=)``
  returns each factor as a ``DTensor`` in that placement on the mesh's
  devices, each rank reading only its block.
- **Async saves.** ``wait=False`` snapshots the tensors and writes in
  the background (``dcp.async_save``); ``wait_for_saves`` joins, and a
  load or a later save of the same path joins first.

The format is DCP's, not orbax's: a directory holding one ``.distcp``
file per rank and a ``.metadata`` file, with the entries
``factors.<name>`` (``factors.<name>.<s>`` for source ``s`` of a
per-source list), ``aux.n_iters``, ``aux.cost`` and ``extra.<name>``.
A save writes into ``<path>.partial`` and renames it over ``path`` once
every rank has written, so a crash during a save leaves the previous
checkpoint readable.  Every rank of the process group calls a save or a
load with the same arguments.
"""
from __future__ import annotations

import os
import shutil

import numpy as np
import torch

from ..core import is_dtensor, to_host

_FACTOR_KEYS = ("W", "H", "P", "G", "S", "Z")
_PENDING: dict = {}  # path -> (future, partial directory)
_GROUP = (None, None)  # (default group, the Gloo group made from it)


def _dist():
    return torch.distributed.is_available() and torch.distributed.is_initialized()


def _group():
    """A Gloo group of every rank, for DCP's planning collectives: an
    async save runs them in a background thread, which must not share a
    group with the solver's collectives in the foreground.  Made anew
    for each default process group; None when there is none."""
    global _GROUP
    if not _dist():
        return None
    world = torch.distributed.group.WORLD
    if _GROUP[0] is not world:
        _GROUP = (world, torch.distributed.new_group(backend="gloo"))
    return _GROUP[1]


def _barrier():
    if _dist():
        torch.distributed.barrier(group=_group())


def _commit(partial, path):
    """Rank 0 renames the finished ``partial`` directory over ``path``."""
    _barrier()
    if not _dist() or torch.distributed.get_rank() == 0:
        old = path + ".old"
        if os.path.isdir(path):
            shutil.rmtree(old, ignore_errors=True)
            os.rename(path, old)
        os.rename(partial, path)
        shutil.rmtree(old, ignore_errors=True)
    _barrier()


def _join(path):
    fut, partial = _PENDING.pop(path)
    getattr(fut, "upload_completion", fut).result()
    _commit(partial, path)


def wait_for_saves() -> None:
    """Block until every pending async save has committed."""
    for path in list(_PENDING):
        _join(path)


def _placements(mesh, spec):
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for ax in mesh.axis_names:
        dims = [d for d, a in enumerate(spec) if a == ax]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def _fits(mesh, spec, shape) -> bool:
    """The placement applies: its rank matches and every sharded
    dimension divides (a trimmed factor of a padded run restores whole,
    and the solver re-pads and re-places it at entry)."""
    if len(spec) != len(shape):
        return False
    return all(ax is None or shape[d] % mesh.size(ax) == 0
               for d, ax in enumerate(spec))


def _as_tensor(v):
    if torch.is_tensor(v):
        return v.detach()
    return torch.as_tensor(np.array(v))  # a C-ordered copy; 0-d stays 0-d


def save_factors_orbax(path, result_or_dict, extra: dict | None = None,
                       *, wait: bool = True, mesh=None,
                       solver: str | None = None) -> None:
    """Persist a Result's factors (and cost trace) to directory ``path``.

    Accepts the same inputs as checkpoint.save_factors.  With ``mesh`` and
    ``solver`` each factor with a placement in
    ``parallel.placements_for(solver)`` is written per shard: each rank
    writes its own block of the (whole, gathered) factor it holds.  With
    ``wait=False`` the call returns once the tensors are staged and the
    write completes in the background.
    """
    import torch.distributed.checkpoint as dcp
    from torch.distributed.tensor import DTensor
    obj = result_or_dict
    if hasattr(obj, "fields"):  # core.Result
        items = {f: getattr(obj, f) for f in obj.fields}
        state = {"aux.n_iters": torch.tensor(int(obj.n_iters))}
    else:
        items = dict(obj)
        state = {}
    specs = {}
    if mesh is not None and solver is not None:
        from ..parallel.mesh import placements_for
        specs = placements_for(solver, mesh)

    def factor(name, v):
        t = _as_tensor(v)
        spec = specs.get(name)
        if spec is None or is_dtensor(t) or not _fits(mesh, spec, t.shape):
            return t
        from ..parallel.mesh import local_block
        local = local_block(mesh, t, spec).to(mesh.device).contiguous()
        return DTensor.from_local(local, mesh.device_mesh, _placements(mesh, spec),
                                  run_check=False, shape=t.shape, stride=t.stride())

    for name, val in items.items():
        if val is None:
            continue
        if name in _FACTOR_KEYS:
            if isinstance(val, (list, tuple)):
                for s, v in enumerate(val):
                    state[f"factors.{name}.{s}"] = factor(name, v)
            else:
                state[f"factors.{name}"] = factor(name, val)
        elif name == "cost":
            state["aux.cost"] = _as_tensor(to_host(val))
    for name, val in (extra or {}).items():
        state[f"extra.{name}"] = _as_tensor(to_host(val))

    path = os.path.abspath(os.fspath(path))
    if path in _PENDING:  # a previous async save of this path may still
        _join(path)       # be writing: join it first
    partial = path + ".partial"
    if not _dist() or torch.distributed.get_rank() == 0:
        shutil.rmtree(partial, ignore_errors=True)
    _barrier()
    kw = dict(checkpoint_id=partial, process_group=_group(), no_dist=not _dist())
    if wait:
        dcp.save(state, **kw)
        _commit(partial, path)
    else:
        _PENDING[path] = (dcp.async_save(state, **kw), partial)


def load_factors_orbax(path, as_inits: bool = True, *, mesh=None,
                       solver: str | None = None) -> dict:
    """Load a checkpoint written by save_factors_orbax.

    With ``as_inits`` (default) factor arrays come back under their
    ``*_init`` kwarg names, ready to splat into a solver.  With ``mesh=``
    and ``solver=`` each factor is restored into that solver's placement
    (``parallel.placements_for``) as a ``DTensor`` on the mesh's devices,
    every rank reading only its block; factors without a placement entry,
    or whose shape the placement does not divide, restore whole on the
    mesh's device.  Without a mesh every entry restores as NumPy; the
    aux and extra entries always do.
    """
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata
    from torch.distributed.tensor import DTensor
    path = os.path.abspath(os.fspath(path))
    wait_for_saves()  # never read a half-written async checkpoint
    meta = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    specs = {}
    if mesh is not None and solver is not None:
        from ..parallel.mesh import placements_for
        specs = placements_for(solver, mesh)

    state = {}
    for key, m in meta.items():
        if not isinstance(m, TensorStorageMetadata):
            continue
        shape, dtype = tuple(m.size), m.properties.dtype
        group, name = key.split(".")[:2]
        spec = specs.get(name) if group == "factors" else None
        if spec is not None and _fits(mesh, spec, shape):
            from ..parallel.mesh import local_block
            local = local_block(mesh, torch.empty(shape, dtype=dtype), spec)
            local = torch.empty(local.shape, dtype=dtype, device=mesh.device)
            state[key] = DTensor.from_local(local, mesh.device_mesh,
                                            _placements(mesh, spec), run_check=False,
                                            shape=torch.Size(shape),
                                            stride=torch.empty(shape).stride())
        elif group == "factors" and mesh is not None:
            state[key] = torch.empty(shape, dtype=dtype, device=mesh.device)
        else:
            state[key] = torch.empty(shape, dtype=dtype)
    dcp.load(state, checkpoint_id=path, process_group=_group(), no_dist=not _dist())

    raw: dict = {}
    lists: dict = {}
    for key, val in state.items():
        parts = key.split(".")
        if parts[0] == "factors":
            val = val if mesh is not None else val.numpy()
            if len(parts) == 3:
                lists.setdefault(parts[1], {})[int(parts[2])] = val
            else:
                raw[parts[1]] = val
        elif parts[0] == "aux":
            raw[parts[1]] = val.numpy()  # host logic reads these
        else:
            raw[f"extra__{parts[1]}"] = val.numpy()
    for name, parts in lists.items():
        raw[name] = [parts[s] for s in range(len(parts))]
    if not as_inits:
        return raw
    return {f"{k}_init": raw[k] for k in _FACTOR_KEYS if k in raw}
