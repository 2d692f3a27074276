"""The least work of one multiplicative-update iteration, and the card's peaks.

Counted from the shapes, whatever implements the iteration, so that a
change to the program cannot move the yardstick:

* FLOPs count the products an iteration cannot do without (2 per
  multiply-add); elementwise work is not counted.
  - KL: the reconstruction W H before each of the two updates and the
    field's product in each, ``8 m n k``; the cost reuses the
    reconstruction that the next W update needs.  The program's fused
    kernels do ``10 m n k`` (their cost pass rebuilds W H); the extra is
    not counted.
  - KL with weights M: also ``M H'`` and ``W' M``, ``12 m n k``.
  - Euclidean (Gram form): ``V H'`` and ``W' V``, ``4 m n k``, and the
    k x k work ``H H'``, ``W (H H')``, ``W' W``, ``(W' W) H``,
    ``4 k^2 (m + n)``.
* Bytes: each of the two updates reads V (and M) once, W and H once, and
  writes the factor it updates once; f32 throughout.  V cannot be read
  fewer than twice: the H update needs all of the new W, which needs all
  of V.

On a mesh the work is the whole problem's, spread over the chips' peaks.
"""
from __future__ import annotations

F32 = 4

# Published dense peaks (NVIDIA H100 data sheet, without sparsity): TF32 on
# the tensor cores, the fastest rate at which the card multiplies f32
# operands, and HBM bandwidth.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"flops": 495e12, "bytes": 3.35e12},  # SXM5
    "NVIDIA H100 PCIe": {"flops": 378e12, "bytes": 2.0e12},
}


def flops_per_iter(cfg, traffic) -> float:
    m, n, k = cfg["m"], cfg["n"], cfg["k"]
    div = cfg["divergence"]
    if div == "kl":
        return float((12 if traffic.get("mask_zero_share") else 8) * m * n * k)
    if div == "euclidean":
        if traffic.get("mask_zero_share"):
            raise ValueError("no least-work count for a weighted Euclidean solve")
        return float(4 * m * n * k + 4 * k * k * (m + n))
    raise ValueError(f"no least-work count for divergence {div!r}")


def bytes_per_iter(cfg, traffic) -> float:
    m, n, k = cfg["m"], cfg["n"], cfg["k"]
    fields = 2 if traffic.get("mask_zero_share") else 1  # V, and M
    per_update = fields * m * n + m * k + k * n  # read once
    return float(F32 * (2 * per_update + m * k + k * n))  # + each factor written once


def peaks(kind: str):
    """The card's published peaks, or None for a card not in the table."""
    return PEAKS.get(kind)


def least_seconds_per_iter(cfg, traffic, kind: str, chips: int):
    """The larger of the FLOPs over the peak rate and the bytes over the
    peak bandwidth, over ``chips`` cards; None for an unknown card."""
    p = peaks(kind)
    if p is None:
        return None
    return max(flops_per_iter(cfg, traffic) / (chips * p["flops"]),
               bytes_per_iter(cfg, traffic) / (chips * p["bytes"]))
