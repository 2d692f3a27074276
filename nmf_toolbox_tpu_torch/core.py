"""Core utilities: parameter validation, result containers, seeded init.

PyTorch counterpart of ``nmf_toolbox_tpu/core.py``: the one config and
validation path every solver shares (reference: ValidateParameters.m,
nmf.m:238-413).

Multi-source semantics (reference: nmf.m:114-117, 228-234): a solver
accepts ``num_basis_elems`` as an int (one source; factors returned as
plain tensors) or a sequence of ints (K sources; factors returned as
lists).  Internally sources are concatenated: W is (m, k_total) with
source s occupying a static column block, H is (k_total, n) with the
matching row block.  Per-source scalars (sparsity) are promoted to
per-column / per-row vectors, so the hot loop has no per-source logic.

Devices are explicit: a tensor input stays on its device, a NumPy input
goes to the ``device=`` the caller names, and to the card when it names
none (with no card that raises: pass ``device="cpu"``).  Default
inits come from a ``torch.Generator`` seeded with ``seed``; they cannot
reproduce the JAX package's ``jax.random`` draws, so cross-package
parity is held with injected ``W_init``/``H_init``.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

# MATLAB double eps (reference uses `eps` as the division guard in every
# multiplicative update, e.g. nmf.m:168,199).
EPS = float(np.finfo(np.float64).eps)  # 2.220446049250313e-16

# Stepsize underflow threshold for projected-gradient line searches
# (reference: nmfsc.m:170,221; cnmfsc.m:190,245).
STEP_UNDERFLOW = 1e-200

# Device-to-host reads made through :func:`host_read`: the line searches,
# the Hoyer projection and the stop rule of ops/loop.run.  A count for
# measurement (chip_smoke.py phase 14 reads it per iteration).
host_reads = 0


def host_read(t: torch.Tensor):
    """``t.tolist()``, counted in :data:`host_reads`: every value the
    projected-gradient solvers and the stop rule bring to the host."""
    global host_reads
    host_reads += 1
    return t.tolist()


# The one context every span returns while no profiler records.
_NO_SPAN = contextlib.nullcontext()
_profiler_enabled = torch._C._autograd._profiler_enabled


def span(name: str):
    """A ``torch.profiler.record_function`` range named ``name`` while a
    profiler records, else one shared ``nullcontext``: with no profiler a
    span costs one call that reads the profiler's state.  Under
    ``torch.profiler`` with CUDA activity the range shares the clock of
    the card's events, so a trace can put each kernel and each idle gap
    down to the span that launched it.  Names are fixed (no per-call
    numbers), so that a trace sums by them."""
    if not _profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def full_f32_matmul():
    """Full-f32 matmuls (no TF32 on CUDA, no bf16/TF32 in oneDNN on the
    CPU) inside the block, whatever the caller set through
    ``allow_tf32``, ``set_float32_matmul_precision`` or
    ``fp32_precision``; the caller's settings come back on exit, normal
    or not.  The projected-gradient solvers need it: their Gram-form
    objectives cancel heavily, and TF32-class products stall the line
    search (the JAX package solves under
    ``default_matmul_precision("highest")`` for the same reason)."""
    backends = (torch.backends.cuda.matmul, torch.backends.mkldnn.matmul)
    saved = [b.fp32_precision for b in backends]
    try:
        for b in backends:
            b.fp32_precision = "ieee"
        yield
    finally:
        for b, p in zip(backends, saved):
            b.fp32_precision = p


def common_scalars(cfg) -> tuple:
    """(maxiter, tolerance, eps, generator): the scalar config every
    solver shares, with the reference's invalid-value fallbacks
    (ValidateParameters.m:222-230).  The generator is a CPU
    ``torch.Generator`` seeded with ``seed`` (default 0)."""
    maxiter = int(cfg.get("maxiter", 100) or 100)
    if maxiter <= 0:
        maxiter = 100
    tolerance = float(cfg.get("tolerance", 1e-3))
    if tolerance <= 0:
        tolerance = 1e-3
    eps = float(cfg.get("eps", EPS))
    gen = torch.Generator().manual_seed(int(cfg.get("seed", 0)))
    return maxiter, tolerance, eps, gen


def parse_cost_every(cfg) -> int:
    """``cost_every`` config key: evaluate the objective every N
    iterations instead of every one.  The objective feeds only the
    stopping rule (nmf.m:221-224), never the multiplicative updates, so
    the factor trajectory is bit-identical at any cadence; see
    ops/loop.cost_cadence."""
    ce = cfg.get("cost_every", 1)
    ce = 1 if ce is None else int(ce)
    if ce < 1:
        raise ValueError("cost_every must be >= 1")
    return ce


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a NumPy dtype or a dtype name
    (``"bfloat16"`` included, which NumPy itself does not name)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    if isinstance(getattr(torch, name, None), torch.dtype):
        return getattr(torch, name)
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


def resolve_dtype(V, dtype) -> torch.dtype:
    """Pick the compute dtype: explicit override > input dtype > float32."""
    if dtype is not None:
        return torch_dtype(dtype)
    if torch.is_tensor(V):
        d = V.dtype
        return d if (d.is_floating_point or d.is_complex) else torch.float32
    d = np.asarray(V).dtype
    if np.issubdtype(d, np.floating) or np.issubdtype(d, np.complexfloating):
        return torch_dtype(d)
    return torch.float32


def real_dtype_of(dtype: torch.dtype) -> torch.dtype:
    """The real dtype of a complex one (complex64 -> float32); a real
    dtype is its own."""
    return dtype.to_real() if dtype.is_complex else dtype


def complex_dtype_of(dtype: torch.dtype) -> torch.dtype:
    """complex128 for float64 (or complex128), complex64 otherwise."""
    return (torch.complex128 if dtype in (torch.float64, torch.complex128)
            else torch.complex64)


def ingest_rescaled(V, dtype, device):
    """nmfsc-family V ingestion (nmfsc.m:57-62): cast once to the compute
    dtype on the run's device, read ``(min, max)`` in one host read,
    raise on a negative entry and divide by the max in the compute
    dtype (the checks run after the cast, as in the JAX package)."""
    Vd = as_tensor(V, dtype, device)
    lo, hi = host_read(torch.stack([torch.min(Vd), torch.max(Vd)]))
    if lo < 0:
        raise ValueError("Negative values in data!")
    return Vd / torch.tensor(hi, dtype=dtype, device=device)


def concrete_device(device) -> torch.device:
    """``device`` as a ``torch.device`` with an index: ``"cuda"`` names the
    current card, which a tensor made there reports as ``cuda:N``, so
    only the indexed form compares equal to a tensor's device."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def resolve_device(V, device, mesh=None) -> torch.device:
    """The run's device: a tensor's own device, else ``device``, else the
    card (the current one: :func:`concrete_device`).  A tensor on another
    device than the one named is an error, never a silent copy; an array
    with no ``device`` and no card raises, never a silent run on the CPU.
    Under a ``mesh`` it is the mesh's device for this rank, whatever V's
    (each rank copies its own block there); a ``device`` that names
    another is an error."""
    if mesh is not None:
        if device is not None and concrete_device(device) != mesh.device:
            raise ValueError(f"device={device!r} but the mesh's device on this "
                             f"rank is {mesh.device}; drop device=")
        return mesh.device
    if torch.is_tensor(V):
        if device is not None and concrete_device(device) != V.device:
            raise ValueError(f"V lies on {V.device} but device={device!r} "
                             "was given; move V or drop device=")
        return V.device
    if device is not None:
        return concrete_device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("nmf_toolbox_tpu_torch runs on a CUDA card unless "
                           "told otherwise and finds none; pass device=\"cpu\" "
                           "to run on the CPU")
    return concrete_device("cuda")


def staging_device(V, device, mesh) -> torch.device:
    """Where a solver holds the whole arrays before placement: the run's
    device with no mesh; under a mesh V's own device for a tensor and the
    host for an array, so that only each rank's block moves to its device
    (``parallel.apply_placements``)."""
    if mesh is None:
        return device
    return V.device if torch.is_tensor(V) else torch.device("cpu")


def is_dtensor(x) -> bool:
    """True for a ``torch.distributed.tensor.DTensor``."""
    if not (torch.is_tensor(x) and torch.distributed.is_available()):
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def as_tensor(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A tensor of ``dtype`` on ``device`` from a tensor or an array; a
    sharded ``DTensor`` (a restore of ``utils.load_factors_orbax`` with
    ``mesh=``) is gathered whole first."""
    if is_dtensor(x):
        from .parallel.collectives import dtensor_whole
        x = dtensor_whole(x)
    if torch.is_tensor(x):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), device=device).to(dtype)


def to_host(x) -> np.ndarray:
    """A NumPy copy of a tensor on any device (a complex one stays
    complex), or ``np.asarray`` of anything else: what every writer of
    results to disk or to NumPy callers goes through, since ``np.asarray``
    of a CUDA tensor raises."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def as_list(x) -> tuple[list, bool]:
    """Normalize scalar-or-sequence to a list; report whether it was a
    sequence (the cell-array promotion of nmf.m:114-116)."""
    if isinstance(x, (list, tuple)):
        return list(x), True
    return [x], False


def promote_per_source(value, num_sources: int, name: str, default):
    """Promote a scalar-or-list config value to a per-source list
    (ValidateParameters.m:130-220)."""
    if value is None:
        value = default
    if isinstance(value, (list, tuple)):
        vals = list(value)
        if len(vals) == 1:
            vals = vals * num_sources
        if len(vals) != num_sources:
            raise ValueError(
                f"Requested {num_sources} sources. Given {len(vals)} {name} values."
            )
        return vals
    return [value] * num_sources


def promote_inits(inits, num_sources: int, name: str) -> tuple[list | None, bool]:
    """Normalize user-supplied factor inits to a per-source list (or
    None).  Returns (list_or_none, was_sequence); tensors stay tensors.
    Reference: ValidateParameters.m:33-66 / nmf.m:269-309."""
    def keep(a):
        return a if torch.is_tensor(a) else np.asarray(a)
    if inits is None:
        return None, num_sources > 1
    if isinstance(inits, (list, tuple)):
        if len(inits) != num_sources:
            raise ValueError(
                f"Requested {num_sources} sources. Given {len(inits)} initial {name} matrices."
            )
        return [keep(a) for a in inits], True
    return [keep(inits)], False


def source_blocks(ks: Sequence[int]) -> tuple[tuple[int, int], ...]:
    """Static (start, stop) column blocks for each source in concatenated W/H."""
    out, off = [], 0
    for k in ks:
        out.append((off, off + int(k)))
        off += int(k)
    return tuple(out)


def per_column(values: Sequence[float], ks: Sequence[int], dtype,
               device=None) -> torch.Tensor:
    """Expand per-source scalars to a per-column (length sum(ks)) vector."""
    return torch.cat([torch.full((int(k),), float(v), dtype=dtype, device=device)
                      for v, k in zip(values, ks)])


def fixed_col_mask(fixed: Sequence[bool], ks: Sequence[int]) -> np.ndarray:
    """Boolean mask (length sum(ks)): True where the source's factor is frozen."""
    return np.concatenate(
        [np.full((int(k),), bool(f)) for f, k in zip(fixed, ks)]
    )


# ---------------------------------------------------------------------------
# Random initialization (reference inits use MATLAB rand(); here a seeded
# CPU torch.Generator, drawn on the host and moved to the run's device so
# that a seed gives the same init on every device).
# ---------------------------------------------------------------------------

def uniform_init(gen, shape, dtype, device=None, floor_eps: bool = True):
    """max(rand(shape), eps) — reference ValidateParameters.m:43,79."""
    x = torch.rand(shape, generator=gen, dtype=torch.float64)
    if floor_eps:
        x = torch.clamp_min(x, EPS)
    return x.to(device=device, dtype=dtype)


def default_w_init(gen, m, ks, dtype, device=None, normalize=True):
    """Per-source random W, unit-L2 columns (ValidateParameters.m:79-81)."""
    ws = []
    for k in ks:
        w = uniform_init(gen, (m, int(k)), dtype, device)
        if normalize:
            w = w / torch.sqrt(torch.sum(w * w, dim=0, keepdim=True))
        ws.append(w)
    return ws


def default_h_init(gen, ks, n, dtype, device=None):
    """Per-source random H (ValidateParameters.m:43)."""
    return [uniform_init(gen, (int(k), n), dtype, device) for k in ks]


# ---------------------------------------------------------------------------
# Result container
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Result:
    """Solver output.  Tuple-unpacks in the reference's output order, so
    ``W, H, cost = nmf(...)`` works exactly like the MATLAB call
    ``[W, H, cost] = nmf(...)`` (nmf.m:1)."""

    fields: tuple[str, ...]
    W: Any = None
    H: Any = None
    cost: Any = None
    P: Any = None
    G: Any = None
    S: Any = None
    Z: Any = None
    A: Any = None
    n_iters: int = 0
    converged: bool = False
    resume_state: Any = None

    def __iter__(self):
        return iter(getattr(self, f) for f in self.fields)

    def __len__(self):
        return len(self.fields)

    def __getitem__(self, i):
        return getattr(self, self.fields[i])

    @property
    def final_cost(self) -> float:
        """Last valid cost entry, robust to per-solver trace semantics
        (initial-cost offset traces have length n_iters+1; lnmf's
        untrimmed trace is zero-padded past n_iters).  For the batched
        engines' (B, iters) traces this is the best problem's final cost
        (the min over the batch at the last iteration); ``cost[:, -1]``
        gives the per-problem values.  ``cost`` is NumPy, so this is a
        Python float from NumPy."""
        c = np.asarray(self.cost)
        if c.ndim == 2:
            return float(np.min(c[:, -1]))
        n = int(self.n_iters)
        if len(c) in (n, n + 1) or n == 0:
            return float(c[-1])
        return float(c[max(n - 1, 0)])


def unwrap_sources(arr, blocks, axis: int, was_seq: bool):
    """Split a concatenated factor back into per-source tensors (on the
    factor's device); a plain tensor when the caller passed a scalar
    source spec (reference: nmf.m:228-234)."""
    parts = []
    for (a, b) in blocks:
        idx = (slice(None),) * axis + (slice(a, b),)
        parts.append(arr[idx].contiguous())
    if not was_seq:
        return parts[0]
    return parts


def merge_config(config, kwargs) -> dict:
    """Merge a MATLAB-style config dict with keyword overrides."""
    out = dict(config or {})
    out.update({k: v for k, v in kwargs.items() if v is not None})
    return out
