"""Divergence library: gradient fields and cost functions.

PyTorch counterpart of ``nmf_toolbox_tpu/ops/divergence.py``.  Every
multiplicative update factors through two m-by-n "fields" Phi_neg /
Phi_pos of (V, V_hat):

  W-update:  neg = Phi_neg @ Hs'  + Ws * diag(Hs @ Phi_pos' @ Ws)
             pos = Phi_pos @ Hs'  + Ws * diag(Hs @ Phi_neg' @ Ws)
             (then ^(1/alpha) or ^(1/beta) for the AB family)
  H-update:  neg = Ws' @ Phi_neg ; pos = Ws' @ Phi_pos   (same power)

Reference equations: nmf.m:147-167 (W), nmf.m:178-199 (H),
cnmf.m:180-232 (with the (alpha,beta) mapping at cnmf.m:137-147).

``Phi_pos`` is ``None`` when it is the all-ones field (KL divergence):
callers exploit this to avoid materializing an m-by-n ones matrix
(ones(m,n) @ H' == broadcast of row-sums of H, nmf.m:153,184).
"""
from __future__ import annotations

import math

import torch

from ..parallel.collectives import sum_all
DIVERGENCES = ("euclidean", "kl_divergence", "kl", "is_divergence", "is",
               "ab_divergence", "ab", "frobenius")


def canon(divergence: str) -> str:
    """Canonicalize divergence aliases (nmf.m:19-22, cnmf.m:137-147)."""
    d = divergence.lower()
    if d in ("euclidean", "frobenius"):
        return "euclidean"
    if d in ("kl_divergence", "kl"):
        return "kl"
    if d in ("is_divergence", "is"):
        return "is"
    if d in ("ab_divergence", "ab"):
        return "ab"
    raise ValueError(
        f"No update equations defined for cost function with divergence type {divergence}"
    )


def ab_params(divergence: str, alpha: float, beta: float) -> tuple[float, float]:
    """Map a named divergence onto AB-divergence (alpha, beta) — cnmf.m:137-147."""
    d = canon(divergence)
    if d == "euclidean":
        return 1.0, 1.0
    if d == "kl":
        return 1.0, 0.0
    if d == "is":
        return 1.0, -1.0
    return float(alpha), float(beta)


def _masked(phi, mask):
    """Zero a field outside the valid region (mesh zero-padding: the pad
    entries are 0/0 or 0**negative and must not leak NaN/Inf into the
    gradient matmuls)."""
    if phi is None or mask is None:
        return phi
    return torch.where(mask, phi, torch.zeros((), dtype=phi.dtype, device=phi.device))


def _weighted(phi, weights):
    """weights * phi with zero-weight entries hard-zeroed FIRST: a
    missing entry (weight 0) may carry NaN/Inf in its field value and
    0 * NaN is NaN — zero-weight entries contribute nothing."""
    return torch.where(weights > 0, weights * phi,
                       torch.zeros((), dtype=phi.dtype, device=phi.device))


def fields(divergence: str, V, V_hat, alpha: float = 1.0, beta: float = 1.0,
           mask=None, weights=None):
    """Return (Phi_neg, Phi_pos, power).

    ``Phi_pos`` of None means the all-ones field; ``power`` of None means no
    exponent is applied to the assembled gradients (the non-AB updates).
    ``mask`` (bool, broadcastable to V) zeroes the fields outside the valid
    region; ``weights`` (nonnegative, broadcastable to V) makes the updates
    minimize sum(weights * d(V, V_hat)) — for KL the implicit all-ones
    Phi_pos BECOMES the weight matrix.  Reference: nmf.m:147-167.
    """
    d = canon(divergence)
    if d == "euclidean":
        if weights is not None:
            return _weighted(V, weights), _weighted(V_hat, weights), None
        return V, V_hat, None
    if d == "kl":
        if weights is not None:
            return (_weighted(_masked(V / V_hat, mask), weights),
                    _masked(weights, mask), None)
        return _masked(V / V_hat, mask), None, None
    if d == "is":
        phi_neg = _masked(V / (V_hat * V_hat), mask)
        phi_pos = _masked(1.0 / V_hat, mask)
        if weights is not None:
            return _weighted(phi_neg, weights), _weighted(phi_pos, weights), None
        return phi_neg, phi_pos, None
    # AB family; alpha == 0 uses the dual equations (nmf.m:124-128,159-160).
    if alpha == 0.0:
        phi_neg = V ** (alpha - 1.0) * V_hat ** beta
        phi_pos = V ** (alpha + beta - 1.0)
        power = 1.0 / beta
    else:
        phi_neg = V ** alpha * V_hat ** (beta - 1.0)
        phi_pos = V_hat ** (alpha + beta - 1.0)
        power = 1.0 / alpha
    phi_neg, phi_pos = _masked(phi_neg, mask), _masked(phi_pos, mask)
    if weights is not None:
        phi_neg = _weighted(phi_neg, weights)
        phi_pos = _weighted(phi_pos, weights)
    return phi_neg, phi_pos, power


def ab_fields(V, V_hat, alpha: float, beta: float, mask=None, weights=None):
    """AB fields for the convolutive family where every divergence is mapped
    to (alpha, beta) first (cnmf.m:137-153, 180-232).  ``mask`` and
    ``weights`` as in :func:`fields`."""
    if alpha == 0.0:
        phi_neg = _masked(V ** (alpha - 1.0) * V_hat ** beta, mask)
        phi_pos = _masked(V ** (alpha + beta - 1.0), mask)
        if weights is not None:
            phi_neg = _weighted(phi_neg, weights)
            phi_pos = _weighted(phi_pos, weights)
        return phi_neg, phi_pos, 1.0 / beta
    if alpha == 1.0 and beta == 1.0:
        phi_neg = V if weights is None else _weighted(V, weights)
    else:
        phi_neg = _masked(V ** alpha * V_hat ** (beta - 1.0), mask)
        if weights is not None:
            phi_neg = _weighted(phi_neg, weights)
    if alpha + beta == 1.0:
        if weights is not None:
            phi_pos = _masked(weights, mask)  # the ones field becomes W
        else:
            phi_pos = torch.ones((), dtype=V.dtype, device=V.device).expand(V_hat.shape)
            # the ones field is position-independent; consumers restrict it
            # to the valid region themselves (the KL special cases)
            phi_pos = _masked(phi_pos, mask)
    elif alpha + beta == 2.0:
        phi_pos = V_hat if weights is None else _weighted(V_hat, weights)
    else:
        phi_pos = _masked(V_hat ** (alpha + beta - 1.0), mask)
        if weights is not None:
            phi_pos = _weighted(phi_pos, weights)
    power = None if alpha == 1.0 else 1.0 / alpha
    return phi_neg, phi_pos, power


def apply_power(x, power):
    return x if power is None or power == 1.0 else x ** power


def _weighted_sum(term, weights, dim=None):
    """sum(weights * term) over ``dim`` (all of it by default) with
    zero-weight entries hard-zeroed FIRST — a masked-out entry may carry
    NaN/Inf in its term (e.g. 0*log(0)) and 0 * NaN is NaN."""
    if weights is None:
        return torch.sum(term, dim=dim)
    return torch.sum(torch.where(weights > 0, weights * term,
                                 torch.zeros((), dtype=term.dtype, device=term.device)),
                     dim=dim)


def cost(divergence: str, V, V_hat, alpha: float = 1.0, beta: float = 1.0,
         mask=None, weights=None, dim=None, mesh=None):
    """Per-iteration cost (nmf.m:206-215; identical in cnmf.m:239-248 and
    constrainednmf.m:241-250).  ``mask`` restricts the elementwise summand
    to the valid region; ``weights`` scales it per entry (see
    :func:`fields`); ``dim`` sums over those dimensions only (a batch of
    problems gets one cost each), over everything by default.  ``mesh``:
    V is this rank's block, and the sum runs over every rank's."""
    def total(term):
        s = _weighted_sum(term, weights, dim)
        return s if mesh is None else sum_all(mesh, s)

    d = canon(divergence)
    if d == "euclidean":
        r = V - V_hat
        return 0.5 * total(r * r)
    if d == "kl":
        return total(_masked(V * torch.log(V / V_hat) - V + V_hat, mask))
    if d == "is":
        return total(_masked(torch.log(V_hat / V) + V / V_hat - 1.0, mask))
    a, b = alpha, beta
    # MATLAB 1/0 == Inf: with alpha*beta == 0 the reference's AB cost is
    # +-Inf (nmf.m:214); the convergence rule then simply never fires.
    factor = -1.0 / (a * b) if a * b != 0.0 else -math.inf
    term = (V ** a * V_hat ** b
            - (a * V ** (a + b) + b * V_hat ** (a + b) + b) / (a + b))
    return factor * total(_masked(term, mask))
