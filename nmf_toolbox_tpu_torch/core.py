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

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

# MATLAB double eps (reference uses `eps` as the division guard in every
# multiplicative update, e.g. nmf.m:168,199).
EPS = float(np.finfo(np.float64).eps)  # 2.220446049250313e-16


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


def resolve_device(V, device) -> torch.device:
    """The run's device: a tensor's own device, else ``device``, else the
    card.  A tensor on another device than the one named is an error,
    never a silent copy; an array with no ``device`` and no card raises,
    never a silent run on the CPU."""
    if torch.is_tensor(V):
        d = None if device is None else torch.device(device)
        if d is not None and (d.type != V.device.type
                              or d.index not in (None, V.device.index)):
            raise ValueError(f"V lies on {V.device} but device={device!r} "
                             "was given; move V or drop device=")
        return V.device
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("nmf_toolbox_tpu_torch runs on a CUDA card unless "
                           "told otherwise and finds none; pass device=\"cpu\" "
                           "to run on the CPU")
    return torch.device("cuda")


def as_tensor(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A tensor of ``dtype`` on ``device`` from a tensor or an array."""
    if torch.is_tensor(x):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), device=device).to(dtype)


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


def prepare_weights(weights, dtype, device, shape):
    """Validate and cast a per-entry weight matrix like V: the one path
    of every solver that takes ``weights=`` (the JAX package's
    parallel/padding.prepare_weights without a mesh)."""
    weights = as_tensor(weights, dtype, device)
    if tuple(weights.shape) != tuple(shape):
        raise ValueError(f"weights has shape {tuple(weights.shape)}, "
                         f"expected {tuple(shape)}")
    # Negative weights would flip update signs through the KL/AB
    # ones-field denominators, and NaN weights poison every update.
    if bool(torch.any(weights < 0) | torch.any(torch.isnan(weights))):
        raise ValueError(
            "weights must be nonnegative and NaN-free; to down-weight or "
            "drop entries use 0, and to mask NaN DATA pass the NaN in V "
            "with weight 0")
    return weights


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
