"""Shape-robust sharding: zero-pad to mesh multiples, mask, slice back
(PyTorch counterpart of ``nmf_toolbox_tpu/parallel/padding.py``).

Every sharded dimension must divide by its mesh axis' size, and
production shapes almost never do.  The solvers therefore pad V and the
factor inits with zeros up to the next mesh multiple before placement,
run the padded problem and slice the factors back.

Zero padding composes exactly with the multiplicative-update algebra:

* zero-initialized factor pads are fixed points of every MU rule (the
  update is X .* ratio, and the padded rows/columns of every numerator
  are zero because V's pads are zero);
* all Gram-form quantities (V H', W'V, H H', W'W, the Gram-form costs)
  receive exactly-zero contributions from the pad region;
* the nonlinear elementwise fields (KL/IS/AB ratios and costs: 0/0) are
  masked where they occur (ops/divergence.py ``mask=``), with masks built
  from each local block's global offsets (ops/masking.py).
"""
from __future__ import annotations

import torch

from ..core import as_tensor, staging_device
from .mesh import FEATURE_AXIS, SAMPLE_AXIS, apply_placements


def mesh_multiples(mesh) -> tuple[int, int]:
    """(feature multiple, sample multiple) the mesh demands; (1, 1) for
    no mesh."""
    if mesh is None:
        return 1, 1
    return mesh.size(FEATURE_AXIS), mesh.size(SAMPLE_AXIS)


def pad_amount(size: int, mult: int) -> int:
    return (-size) % mult


def pad_axes(arr, pads: dict):
    """Zero-pad ``arr`` at the end of the given axes ({axis: amount})."""
    if not any(pads.values()):
        return arr
    widths = []
    for d in reversed(range(arr.ndim)):  # F.pad lists the last axis first
        widths += [0, int(pads.get(d, 0))]
    return torch.nn.functional.pad(arr, widths)


def plan_padding(mesh, m: int, n: int):
    """Return (pad_m, pad_n, valid) where ``valid`` is (m, n) when any
    padding is needed and None otherwise (the no-mask fast path)."""
    mmul, nmul = mesh_multiples(mesh)
    pm, pn = pad_amount(m, mmul), pad_amount(n, nmul)
    return pm, pn, ((m, n) if (pm or pn) else None)


def prepare_weights(weights, dtype, shape, mesh, solver: str,
                    pad_m: int, pad_n: int, valid, device=None):
    """Validate/cast/zero-pad/place a per-entry weight matrix like V.

    One path for every solver that accepts ``weights=`` (nmf, nmf_hals,
    cnmf, constrainednmf): the weight matrix must match V's (m, n), pads
    with ZEROS under a mesh (pad entries contribute nothing to the
    weighted objective), and takes V's placement.  With no mesh it lands
    on ``device``; under a mesh the checks run where the weights are
    given and only this rank's block moves to the mesh's device.
    Returns None for None.
    """
    if weights is None:
        return None
    weights = as_tensor(weights, dtype, staging_device(weights, device, mesh))
    if tuple(weights.shape) != tuple(shape):
        raise ValueError(f"weights has shape {tuple(weights.shape)}, "
                         f"expected {tuple(shape)}")
    # Negative weights would be hard-zeroed in most gradient fields
    # (weights > 0 gate) but flow raw into the KL/AB ones-field
    # denominators, flipping update signs: reject them, and NaN weights
    # with them.
    if bool(torch.any(weights < 0) | torch.any(torch.isnan(weights))):
        raise ValueError(
            "weights must be nonnegative and NaN-free; to down-weight or "
            "drop entries use 0, and to mask NaN DATA pass the NaN in V "
            "with weight 0 (see API.md 'weights')")
    if valid is not None:
        weights = pad_axes(weights, {0: pad_m, 1: pad_n})
    return apply_placements(mesh, solver, V=weights)
