"""Device-mesh sharding for the solver family (PyTorch counterpart of
``nmf_toolbox_tpu/parallel/mesh.py``).

The layout is the JAX package's:

* V (m, n) shards over samples (columns) and optionally features (rows)
  on a 1-D or 2-D mesh; H (k, n) shards with V's columns; W (m, k)
  shards with V's rows (replicated on a 1-D sample mesh).
* Every cross-shard quantity in the MU updates is a k-by-k / m-by-k
  reduction (V H', W'V, H H', W'W).

The execution model differs.  JAX places arrays at the boundary and XLA
inserts the psums.  Here there is one process per device (SPMD, as under
``torchrun``): every rank calls the solver with the same arguments,
:func:`apply_placements` cuts each rank's own contiguous block out of
the full array and moves only that block to the rank's device, the
solver's step runs on local blocks and reduces explicitly through
``parallel/collectives.py``, and the factors are gathered back whole on
every rank at the end.  A :class:`Mesh` wraps a
``torch.distributed.device_mesh.DeviceMesh`` with the JAX axis names.

A placement is a tuple with one entry per array dimension: an axis name
(``"m"`` or ``"n"``) to shard that dimension over, or None to keep it
whole -- the JAX ``PartitionSpec``'s content.  Axes the mesh does not
carry resolve to None.
"""
from __future__ import annotations

import datetime
import os
from typing import NamedTuple

import torch

SAMPLE_AXIS = "n"   # data-parallel over samples (columns of V)
FEATURE_AXIS = "m"  # feature-parallel over rows of V


def local_card(rank: int) -> int:
    """The card a rank's process takes: ``LOCAL_RANK`` (torchrun's index
    of the process on its host), else ``rank``, modulo the cards the
    host has."""
    return int(os.environ.get("LOCAL_RANK", rank)) % torch.cuda.device_count()


class Mesh:
    """A 1-D ``("n",)`` or 2-D ``("m", "n")`` mesh of ranks, one device
    each.  ``device`` is this rank's device (``cuda:{LOCAL_RANK %
    device_count}`` for a CUDA mesh, the CPU otherwise); ``coord(axis)``
    and ``size(axis)`` are this rank's index along an axis and the axis'
    length (0 and 1 for an axis the mesh does not carry); ``group(axis)``
    is the axis' process group."""

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.shape = dict(zip(self.axis_names, device_mesh.mesh.shape))
        if device_mesh.device_type == "cuda":
            self.device = torch.device("cuda", local_card(torch.distributed.get_rank()))
        else:
            self.device = torch.device(device_mesh.device_type)

    def size(self, axis) -> int:
        return self.shape.get(axis, 1) if axis is not None else 1

    def coord(self, axis) -> int:
        if axis is None or axis not in self.shape:
            return 0
        return self.device_mesh.get_local_rank(axis)

    def group(self, axis):
        return self.device_mesh.get_group(axis)

    def __repr__(self):
        return f"Mesh({self.shape}, device={self.device})"


class Sharding(NamedTuple):
    """A placement on a mesh: the counterpart of ``NamedSharding``."""
    mesh: Mesh
    spec: tuple


def check_mesh(mesh):
    """``mesh`` itself when it is None or a port :class:`Mesh`; a
    ``TypeError`` that names :func:`make_mesh` for anything else (a JAX
    mesh, a bare ``DeviceMesh``)."""
    if mesh is None or isinstance(mesh, Mesh):
        return mesh
    raise TypeError(f"mesh= takes a mesh from nmf_toolbox_tpu_torch.parallel."
                    f"make_mesh; got {type(mesh).__name__}")


def make_mesh(n_devices: int | None = None, *, shape=None,
              device_type: str | None = None) -> Mesh:
    """Build a mesh over the sample axis (1-D) or (features, samples) (2-D).

    ``shape=(r, c)`` gives a 2-D mesh with axes (FEATURE_AXIS,
    SAMPLE_AXIS); default: all ranks on the sample axis.  The mesh spans
    every rank of the default process group (:func:`init_distributed`
    or ``torch.distributed.init_process_group`` first), so ``n_devices``
    or ``r * c`` must equal the world size.  ``device_type``: ``"cuda"``
    unless the caller names ``"cpu"``; with no card a CUDA mesh raises,
    never a silent mesh on the CPU (as :func:`core.resolve_device` does).
    """
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh needs an initialized process group: call "
            "nmf_toolbox_tpu_torch.parallel.init_distributed() (under "
            "torchrun) or torch.distributed.init_process_group first")
    world = dist.get_world_size()
    if shape is not None:
        dims, names = tuple(int(s) for s in shape), (FEATURE_AXIS, SAMPLE_AXIS)
        if len(dims) != 2:
            raise ValueError(f"shape= takes (features, samples); got {shape}")
    else:
        dims, names = (world if n_devices is None else int(n_devices),), (SAMPLE_AXIS,)
    total = 1
    for d in dims:
        total *= d
    if total != world:
        raise ValueError(f"a mesh of {dims} needs {total} ranks; the process "
                         f"group has {world} (one rank per device)")
    if device_type is None:
        device_type = "cuda"
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh builds a mesh of CUDA cards unless told "
                               "otherwise and finds none; pass device_type=\"cpu\" "
                               "for a mesh on the CPU")
        torch.cuda.set_device(local_card(dist.get_rank()))
    # The axis groups are made here, every rank making every group in the
    # same order, and handed to DeviceMesh: DeviceMesh's own group set-up
    # hung with two Gloo ranks on one card (torch 2.11).
    ranks = torch.arange(world).reshape(dims)
    me = dist.get_rank()
    if len(dims) == 1:
        groups = [dist.group.WORLD]
    else:
        groups = [None, None]
        for axis, lines in ((0, ranks.T), (1, ranks)):  # columns: "m"; rows: "n"
            for line in lines.tolist():
                g = dist.new_group(line)
                if me in line:
                    groups[axis] = g
    return Mesh(DeviceMesh.from_group(groups if len(groups) > 1 else groups[0],
                                      device_type, ranks, mesh_dim_names=names))


def block_offset(mesh, size: int, axis: str = SAMPLE_AXIS) -> int:
    """The first global index of this rank's block of ``size`` along the
    mesh axis ``axis`` (0 with no mesh): where a block's masks start."""
    return 0 if mesh is None else mesh.coord(axis) * size


def _axes(mesh: Mesh):
    names = mesh.axis_names
    m_ax = FEATURE_AXIS if FEATURE_AXIS in names else None
    n_ax = SAMPLE_AXIS if SAMPLE_AXIS in names else None
    return m_ax, n_ax


def col_sharding(mesh: Mesh) -> Sharding:
    """(x, n)-shaped arrays sharded over samples."""
    m_ax, n_ax = _axes(mesh)
    return Sharding(mesh, (None, n_ax))


def row_sharding(mesh: Mesh) -> Sharding:
    """(m, x)-shaped arrays sharded over features."""
    m_ax, n_ax = _axes(mesh)
    return Sharding(mesh, (m_ax, None))


def grid_sharding(mesh: Mesh) -> Sharding:
    """(m, n)-shaped arrays sharded over both axes (2-D mesh)."""
    m_ax, n_ax = _axes(mesh)
    return Sharding(mesh, (m_ax, n_ax))


def replicate(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def local_block(mesh: Mesh, x, spec):
    """This rank's block of the full array or tensor ``x`` under
    ``spec``, as a view (no copy); every sharded dimension must divide
    by its axis' size."""
    x = x if torch.is_tensor(x) else torch.as_tensor(x)
    for d, ax in enumerate(spec):
        size = mesh.size(ax)
        if size == 1:
            continue
        if x.shape[d] % size:
            raise ValueError(
                f"dimension {d} of an array of shape {tuple(x.shape)} has size "
                f"{x.shape[d]}, which the mesh axis {ax!r} of size {size} does "
                "not divide")
        step = x.shape[d] // size
        x = x.narrow(d, mesh.coord(ax) * step, step)
    return x


def shard(mesh: Mesh, x, spec):
    """This rank's block of ``x`` under ``spec``, contiguous, on the
    mesh's device: the counterpart of ``device_put`` into a
    ``NamedSharding``."""
    return local_block(mesh, x, spec).to(mesh.device).contiguous()


# Placement tables per solver: name -> placement.  Axes that a mesh
# doesn't carry resolve to None (replicated along that dim).
def placements_for(solver: str, mesh: Mesh) -> dict:
    m_ax, n_ax = _axes(mesh)
    V = (m_ax, n_ax)         # data
    Wrow = (m_ax, None)      # basis: rows with features
    Hcol = (None, n_ax)      # encoding: columns with samples
    table = {
        "nmf": {"V": V, "W": Wrow, "H": Hcol},
        "lnmf": {"V": V, "W": Wrow, "H": Hcol},
        "nmfsc": {"V": V, "W": Wrow, "H": Hcol},
        "seminmf": {"V": V, "W": Wrow, "H": Hcol},
        "constrainednmf": {"V": V, "W": Wrow, "Z": (None, None)},
        "cnmf": {"V": V, "W": (m_ax, None, None), "H": Hcol},
        "cnmfsc": {"V": V, "W": (m_ax, None, None),
                   "W2": (m_ax, None, None), "H": Hcol},
        "cmfwisa": {"V": V, "W": Wrow, "H": Hcol, "P": (None, m_ax, n_ax)},
        # symmetric NMF: A's rows and H's rows shard together over the
        # feature axis, A's columns over the sample axis.
        "symnmf": {"A": V, "H": Wrow},
        # 2-D deconvolution: samples shard (time halos as in cnmf); the
        # feature axis stays replicated so the pitch shifts are local.
        "nmf2d": {"V": (None, n_ax), "W": (None, None, None),
                  "H": (None, n_ax, None)},
        # Gram family: the n-by-n Gram shards over samples on one side.
        "convexnmf": {"V": V, "G": (n_ax, None), "H": Hcol},
        "chnmf": {"V": V, "S": Wrow, "G": (None, None), "H": Hcol},
        # chcnmf's placed "V" is the p-by-n Gram S'V: the hull size p is
        # data-dependent and small, so its axis is replicated.
        "chcnmf": {"V": (None, n_ax), "S": Wrow,
                   "G": (None, None, None), "H": Hcol},
        # batched serving: shard the BATCH axis (data-parallel problems);
        # the sample axis of the mesh carries the batch dimension here.
        "nmf_batched": {"V": (n_ax, None, None), "W": (n_ax, None, None),
                        "H": (n_ax, None, None)},
        # fixed-dictionary encoding: problems shard over the batch axis,
        # the shared dictionary (m-by-k, small) is replicated.
        "nmf_encode": {"V": (n_ax, None, None), "W": (None, None),
                       "H": (n_ax, None, None)},
        "cnmf_encode": {"V": (n_ax, None, None), "W": (None, None, None),
                        "H": (n_ax, None, None)},
        # complex encode: V (B, m, n) and P (B, S, m, n) shard over the
        # batch axis like the other encodes.
        "cmfwisa_encode": {"V": (n_ax, None, None), "W": (None, None),
                           "H": (n_ax, None, None),
                           "P": (n_ax, None, None, None)},
        "nmf2d_encode": {"V": (n_ax, None, None),
                         "W": (None, None, None),
                         "H": (n_ax, None, None, None)},
        # multi-restart (rank selection): the SHARED V shards over
        # features only (every restart reads all of it), restarts shard
        # over the sample axis; the only collectives are the sums of W's
        # row reductions along the feature axis.
        "nmf_multiseed": {"V": (m_ax, None), "W": (n_ax, m_ax, None),
                          "H": (n_ax, None, None)},
    }
    return table[solver]


def apply_placements(mesh: Mesh | None, solver: str, **arrays):
    """Each named array's block under its solver placement, contiguous on
    the mesh's device (:func:`shard`); the arrays as given when mesh is
    None.  Returns the arrays in the given order."""
    if mesh is None:
        out = tuple(arrays.values())
    else:
        specs = placements_for(solver, mesh)
        out = tuple(shard(mesh, a, specs[name]) for name, a in arrays.items())
    return out if len(out) > 1 else out[0]


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, backend=None, **kwargs):
    """Join this process to the job's process group (the counterpart of
    ``jax.distributed.initialize``).

    Call once per process before :func:`make_mesh`.  With no arguments
    it reads torchrun's environment (``MASTER_ADDR``/``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``); otherwise ``coordinator_address`` is
    ``host:port`` (or any ``init_method`` URL such as ``file://...``),
    ``num_processes`` the world size and ``process_id`` this rank.
    ``backend``: NCCL when a card is present, Gloo otherwise.  Under NCCL
    the process takes the card :func:`local_card` names.  Other
    keyword arguments (``timeout=`` in seconds or as a ``timedelta``) go
    to ``torch.distributed.init_process_group``.
    """
    import torch.distributed as dist
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    world = int(os.environ["WORLD_SIZE"] if num_processes is None else num_processes)
    rank = int(os.environ["RANK"] if process_id is None else process_id)
    timeout = kwargs.pop("timeout", None)
    if timeout is not None and not isinstance(timeout, datetime.timedelta):
        timeout = datetime.timedelta(seconds=float(timeout))
    if timeout is not None:
        kwargs["timeout"] = timeout
    if backend == "nccl":
        torch.cuda.set_device(local_card(rank))
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank, **kwargs)
