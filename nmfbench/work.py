"""The least work of one iteration, and the card's peaks.

Each solver module counts its own iteration's least FLOPs and bytes from
the shapes (``solvers/<solver>.py: flops_per_iter, bytes_per_iter``),
whatever implements the iteration, so that a change to the program
cannot move the yardstick; here they meet the card's published peaks.  A
function that takes ``solver=None`` uses the solver module of ``cfg``
(``cells.solver``).  On a mesh the work is the whole problem's, spread
over the chips' peaks.
"""
from __future__ import annotations

from . import cells

# Published dense peaks (NVIDIA H100 data sheet, without sparsity): TF32 on
# the tensor cores, the fastest rate at which the card multiplies f32
# operands, and HBM bandwidth.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"flops": 495e12, "bytes": 3.35e12},  # SXM5
    "NVIDIA H100 PCIe": {"flops": 378e12, "bytes": 2.0e12},
}


def flops_per_iter(cfg, traffic, solver=None) -> float:
    """The least FLOPs of one iteration (the solver's count)."""
    return float((solver or cells.solver(cfg)).flops_per_iter(cfg, traffic))


def bytes_per_iter(cfg, traffic, solver=None) -> float:
    """The least bytes of one iteration (the solver's count)."""
    return float((solver or cells.solver(cfg)).bytes_per_iter(cfg, traffic))


def peaks(kind: str):
    """The card's published peaks, or None for a card not in the table."""
    return PEAKS.get(kind)


def least_seconds_per_iter(cfg, traffic, kind: str, chips: int, solver=None):
    """The larger of the FLOPs over the peak rate and the bytes over the
    peak bandwidth, over ``chips`` cards; None for an unknown card."""
    p = peaks(kind)
    if p is None:
        return None
    return max(flops_per_iter(cfg, traffic, solver) / (chips * p["flops"]),
               bytes_per_iter(cfg, traffic, solver) / (chips * p["bytes"]))
