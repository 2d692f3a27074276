"""NNDSVD initialization (PyTorch counterpart of the NNDSVD part of
``nmf_toolbox_tpu/utils/init.py``).

Random draws come from a ``torch.Generator`` in place of ``jax.random``
keys, on the generator's own device, and move to V's device.  The two
packages therefore draw different sketches from the same seed; the
result agrees across packages only where it does not depend on the
sketch (an exactly low-rank V, see tests/test_torch_init.py).
"""
from __future__ import annotations

import numpy as np
import torch


def seedable(V):
    """Zero-fill NaN before seeding: NaN may legitimately sit at
    zero-weight entries of a weighted problem, and the seeding would
    otherwise silently return all-NaN factors."""
    return torch.where(torch.isnan(V), torch.zeros((), dtype=V.dtype, device=V.device), V)


def _working_eps(dtype) -> float:
    """Machine epsilon of the operand dtype, capped at float32's: f64
    runs use ~1e-16 ridges and floors, while bf16/f16 operands (whose
    products accumulate in f32) fall back to float32's eps, since a
    1e-2-scale ridge would wreck the Gram."""
    f32 = float(torch.finfo(torch.float32).eps)
    if not dtype.is_floating_point:
        return f32
    return min(float(torch.finfo(dtype).eps), f32)


def _cholesky_qr(A, eps: float):
    """Orthonormalize the columns of a tall-skinny A via Cholesky-QR.

    One k-by-k Gram and a triangular solve instead of Householder QR on
    the tall operand.  Squares the condition number, which the
    randomized-SVD power iterations tolerate (they re-orthogonalize
    repeatedly).  Columns are pre-normalized (the span is unchanged), so
    the Gram has a unit diagonal, and a k*eps ridge keeps the Cholesky
    positive-definite for exactly rank-deficient sketches.
    """
    tiny = float(np.finfo(np.float32).tiny)
    norms = torch.sqrt(torch.sum(A * A, dim=0))
    A = A / torch.clamp_min(norms, tiny)[None, :]
    G = A.T @ A
    k = G.shape[0]
    G = G + (k * eps) * torch.eye(k, dtype=A.dtype, device=A.device)
    R = torch.linalg.cholesky(G, upper=True)
    return torch.linalg.solve_triangular(R, A, upper=True, left=False)  # A R^-1


def _randomized_svd(generator, V, k: int, oversample: int = 10,
                    power_iters: int = 2):
    """Truncated randomized SVD (Halko et al. 2011).

    V is touched only through matmuls; the dense decompositions run on
    (p, p) Grams of the (m|n, p) sketches (Cholesky-QR and eigh).  Power
    iterations with re-orthogonalization sharpen the spectrum enough for
    an initialization; this is not a certified SVD.
    """
    m, n = V.shape
    p = int(min(k + oversample, m, n))
    eps = _working_eps(V.dtype)
    Om = torch.randn((n, p), generator=generator, dtype=V.dtype,
                     device=generator.device).to(V.device)
    Q = _cholesky_qr(V @ Om, eps)
    for _ in range(power_iters):
        Z = _cholesky_qr(V.T @ Q, eps)
        Q = _cholesky_qr(V @ Z, eps)
    B = Q.T @ V                                   # (p, n)
    # SVD of B from the (p, p) eigendecomposition of B B'.
    vals, Ub = torch.linalg.eigh(B @ B.T)         # ascending
    vals, Ub = vals.flip(0), Ub.flip(1)
    s = torch.sqrt(torch.clamp_min(vals, 0.0))
    Vt = (Ub.T @ B) / torch.maximum(s, eps * torch.max(s))[:, None]
    return (Q @ Ub)[:, :k], s[:k], Vt[:k, :]


def nndsvd(V, k: int, *, generator=None, variant: str = "nndsvdar",
           dtype=None, oversample: int = 10, power_iters: int = 2):
    """Nonnegative Double SVD initialization: (W0, H0) for V ~ W @ H.

    variants (zeros are absorbing states for multiplicative updates):
      'nndsvd'    exact sign-split factors; keeps hard zeros
      'nndsvda'   zeros replaced with mean(V)
      'nndsvdar'  zeros replaced with uniform(0, mean(V)/100)  [default]

    ``V`` is a tensor (its device is the run's) or an array (CPU);
    ``generator`` a ``torch.Generator`` (default: CPU, seed 0).
    """
    if variant not in ("nndsvd", "nndsvda", "nndsvdar"):
        raise ValueError(f"unknown NNDSVD variant {variant!r}")
    if not torch.is_tensor(V):
        V = torch.as_tensor(np.asarray(V))
    if dtype is not None:
        from ..core import torch_dtype
        V = V.to(torch_dtype(dtype))
    if k > min(V.shape):
        # the randomized sketch is capped at min(m, n) columns; silently
        # returning fewer than k components would corrupt callers
        raise ValueError(
            f"NNDSVD needs k <= min(V.shape) = {min(V.shape)}, got k = {k}")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    U, s, Vt = _randomized_svd(generator, V, k, oversample, power_iters)
    tiny = float(torch.finfo(s.dtype).tiny)

    # Leading triplet: nonnegative up to sign (Perron-Frobenius for
    # nonnegative V); abs() fixes the SVD's sign ambiguity.
    w0 = torch.sqrt(s[0]) * torch.abs(U[:, 0])
    h0 = torch.sqrt(s[0]) * torch.abs(Vt[0, :])

    # Remaining triplets, vectorized over j: keep the dominant
    # sign-consistent half of each rank-1 term.
    Uj, Vj = U[:, 1:], Vt[1:, :]
    up, un = torch.clamp_min(Uj, 0.0), torch.clamp_min(-Uj, 0.0)
    vp, vn = torch.clamp_min(Vj, 0.0), torch.clamp_min(-Vj, 0.0)
    upn = torch.sqrt(torch.sum(up * up, dim=0))
    unn = torch.sqrt(torch.sum(un * un, dim=0))
    vpn = torch.sqrt(torch.sum(vp * vp, dim=1))
    vnn = torch.sqrt(torch.sum(vn * vn, dim=1))
    mp, mn_ = upn * vpn, unn * vnn
    use_p = mp >= mn_
    u = torch.where(use_p[None, :], up / torch.clamp_min(upn, tiny)[None, :],
                    un / torch.clamp_min(unn, tiny)[None, :])
    v = torch.where(use_p[:, None], vp / torch.clamp_min(vpn, tiny)[:, None],
                    vn / torch.clamp_min(vnn, tiny)[:, None])
    sig = torch.sqrt(s[1:] * torch.where(use_p, mp, mn_))
    W = torch.cat([w0[:, None], u * sig[None, :]], dim=1)
    H = torch.cat([h0[None, :], v * sig[:, None]], dim=0)

    if variant != "nndsvd":
        vmean = torch.mean(V)
        if variant == "nndsvda":
            fw = fh = vmean
        else:  # nndsvdar
            def draw(shape):
                return torch.rand(shape, generator=generator, dtype=W.dtype,
                                  device=generator.device).to(W.device)
            fw = draw(W.shape) * (vmean / 100.0)
            fh = draw(H.shape) * (vmean / 100.0)
        W = torch.where(W > 0, W, fw)
        H = torch.where(H > 0, H, fh)
    return W, H
