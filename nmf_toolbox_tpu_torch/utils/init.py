"""Initialization recipes off the hot path (PyTorch counterpart of
``nmf_toolbox_tpu/utils/init.py``): k-means for the semi/convex family's
indicator H, NNDSVD, and convex-hull anchors for chnmf.

Random draws come from a ``torch.Generator`` in place of ``jax.random``
keys, and move to V's device.  The two packages therefore draw different
numbers from the same seed; a result agrees across packages only where
it does not depend on the draws (an exactly low-rank V for NNDSVD, the
partition of well-separated clusters for k-means, the exact-path hull
anchors; see tests/test_torch_init.py and tests/test_torch_gram_family.py).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import as_tensor, resolve_device, resolve_dtype, torch_dtype


def _device_generator(generator, device):
    """``generator`` when it draws on ``device``, else a generator there
    seeded from it, so that draws on the card stay seeded and never wait
    on the host."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    if generator.device.type == torch.device(device).type:
        return generator
    seed = int(torch.randint(2 ** 62, (1,), generator=generator))
    return torch.Generator(device=device).manual_seed(seed)


# ---------------------------------------------------------------------------
# k-means
# ---------------------------------------------------------------------------

def kmeans(generator, X, k: int, *, maxiter: int = 100, tol: float = 1e-6,
           device=None):
    """Lloyd's k-means on the rows of X (n, d) with kmeans++ seeding.

    Returns (labels (n,), centers (k, d)) on X's device.  ``X`` is a
    tensor or an array, which goes to ``device`` (default: the card, as
    :func:`nndsvd`); ``generator`` a ``torch.Generator`` (default: CPU,
    seed 0).  The seeding keeps a running minimum of the squared distance
    to the centers so far, so each step measures against the newest
    center only (O(k n d) in all); its draws are ``torch.multinomial``
    on those distances.  The Lloyd loop reads the device once per
    iteration, for whether a center moved by more than ``tol``.
    """
    X = as_tensor(X, resolve_dtype(X, None), resolve_device(X, device))
    gen = _device_generator(generator, X.device)
    n, d = X.shape
    x_sq = torch.sum(X * X, dim=1)

    first = torch.randint(n, (1,), generator=gen, device=X.device)
    centers = torch.zeros((k, d), dtype=X.dtype, device=X.device)
    centers[0] = X[first[0]]
    dmin = torch.full((n,), float("inf"), dtype=X.dtype, device=X.device)
    for i in range(1, k):
        c = centers[i - 1]  # the center picked in the previous step
        d_new = torch.clamp_min(x_sq - 2.0 * (X @ c) + torch.sum(c * c), 0.0)
        dmin = torch.minimum(dmin, d_new)
        total = torch.sum(dmin)
        probs = torch.where(total > 0, dmin / total, torch.full_like(dmin, 1.0 / n))
        idx = torch.multinomial(probs, 1, generator=gen)
        centers[i] = X[idx[0]]

    def assign(centers):
        dists = (x_sq[:, None] - 2.0 * X @ centers.T
                 + torch.sum(centers ** 2, dim=1)[None, :])
        return torch.argmin(dists, dim=1)

    labels = assign(centers)
    arange = torch.arange(k, device=X.device)
    it, moved = 0, True
    while it < maxiter and moved:
        onehot = (labels[:, None] == arange[None, :]).to(X.dtype)
        counts = torch.sum(onehot, dim=0)
        sums = onehot.T @ X
        new_centers = torch.where(counts[:, None] > 0,
                                  sums / torch.clamp_min(counts[:, None], 1.0),
                                  centers)
        labels = assign(new_centers)
        moved = bool(torch.max(torch.sum((new_centers - centers) ** 2, dim=1)) > tol)
        centers, it = new_centers, it + 1
    return labels, centers


def kmeans_indicator_h(generator, V, k: int, dtype=None, offset: float = 0.2,
                       *, device=None):
    """Indicator-matrix H init: H[c_j, j] = 1, then + offset, with c_j the
    k-means cluster of column j of V (ValidateParameters.m:45-54,
    seminmf.m:109-117).  (k, n) in ``dtype`` (default: V's) on V's
    device; ``device`` as in :func:`kmeans`."""
    V = as_tensor(V, resolve_dtype(V, dtype), resolve_device(V, device))
    labels, _ = kmeans(generator, V.T, k)
    H = (labels[None, :] == torch.arange(k, device=V.device)[:, None]).to(V.dtype)
    return H + offset


# ---------------------------------------------------------------------------
# NNDSVD (Boutsidis & Gallopoulos 2008)
# ---------------------------------------------------------------------------

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
           dtype=None, device=None, oversample: int = 10, power_iters: int = 2):
    """Nonnegative Double SVD initialization: (W0, H0) for V ~ W @ H.

    variants (zeros are absorbing states for multiplicative updates):
      'nndsvd'    exact sign-split factors; keeps hard zeros
      'nndsvda'   zeros replaced with mean(V)
      'nndsvdar'  zeros replaced with uniform(0, mean(V)/100)  [default]

    ``V`` is a tensor (its device is the run's) or an array, which goes
    to ``device`` (default: the CUDA card; with no card this raises, so
    pass ``device="cpu"`` to seed on the CPU); ``generator`` a
    ``torch.Generator`` (default: CPU, seed 0).
    """
    if variant not in ("nndsvd", "nndsvda", "nndsvdar"):
        raise ValueError(f"unknown NNDSVD variant {variant!r}")
    device = resolve_device(V, device)
    if not torch.is_tensor(V):
        V = torch.as_tensor(np.asarray(V), device=device)
    if dtype is not None:
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


# ---------------------------------------------------------------------------
# Convex-hull anchor extraction (chnmf.m:85-106)
# ---------------------------------------------------------------------------

def _descending(vals):
    """Indices sorting ``vals`` high to low, ties in the reverse of their
    order (the JAX package's ``argsort(vals)[::-1]``)."""
    return torch.argsort(vals, stable=True).flip(0)


def _top_eigvecs_exact(V):
    """Exact covariance eigendecomposition for small m (chnmf.m:90-93):
    ``torch.cov`` of V's rows as variables (MATLAB's cov(V'))."""
    vals, vecs = torch.linalg.eigh(torch.cov(V))
    order = _descending(vals)
    return vals[order], vecs[:, order]


def _randomized_spectrum(V, num: int, seed: int, iters: int):
    """Randomized subspace iteration for the top ``num`` eigenpairs of
    cov(V') and the Hutchinson estimate of ||cov||_F^2, touching the
    covariance only through products with the centered V (the m-by-m
    matrix is never formed).  Cholesky-QR re-orthogonalizes as in
    :func:`_randomized_svd`; the probes come from generators seeded with
    ``seed`` and ``seed + 1``."""
    m, n = V.shape
    Vc = V - torch.mean(V, dim=1, keepdim=True)
    eps = _working_eps(V.dtype)

    def matvec_c(Q):
        return Vc @ (Vc.T @ Q) / (n - 1.0)

    def probes(s, cols):
        return torch.randn((m, cols), generator=torch.Generator().manual_seed(s),
                           dtype=V.dtype).to(V.device)

    Q = probes(seed, num)
    for _ in range(iters):
        Q = _cholesky_qr(matvec_c(Q), eps)
    vals, S = torch.linalg.eigh(Q.T @ matvec_c(Q))
    order = _descending(vals)
    CZ = matvec_c(probes(seed + 1, 8))
    total_sq = torch.mean(torch.sum(CZ * CZ, dim=0))
    return vals[order], (Q @ S)[:, order], total_sq


def _convhull_2d(points: np.ndarray) -> np.ndarray:
    """Indices of the 2-D convex hull of ``points`` (n, 2), ascending.

    Andrew's monotone chain over f64 coordinates (MATLAB convhull,
    chnmf.m:100); collinear boundary points are dropped.  The native C++
    chain (``native.convhull2d``) runs when it built, the same chain in
    Python otherwise.  Non-finite points are left out rather than
    compared: a chain over NaN comparisons can write past the native
    output buffer."""
    finite = np.isfinite(points).all(axis=1)
    if not finite.all():
        keep_idx = np.nonzero(finite)[0]
        if keep_idx.size == 0:
            return np.empty((0,), dtype=np.int64)
        return keep_idx[_convhull_2d(points[keep_idx])]
    from .. import native
    idx = native.convhull2d(points)
    if idx is not None:
        return idx
    order = np.lexsort((points[:, 1], points[:, 0])).tolist()
    pts = np.asarray(points, np.float64).tolist()

    def half(idx_iter):
        hull = []
        for i in idx_iter:
            px, py = pts[i]
            while len(hull) >= 2:
                ox, oy = pts[hull[-2]]
                ax, ay = pts[hull[-1]]
                if (ax - ox) * (py - oy) - (ay - oy) * (px - ox) <= 0:
                    hull.pop()
                else:
                    break
            hull.append(i)
        return hull

    lower = half(order)
    upper = half(order[::-1])
    return np.unique(np.array(lower[:-1] + upper[:-1], dtype=np.int64))


def convex_hull_anchors(V, pct_eigval_energy: float = 0.95,
                        max_eigvecs: int = 16, seed: int = 0, *, device=None):
    """Hull anchor columns S of V (chnmf.m:85-106), (m, p) on V's device.

    Keeps the top-E principal directions covering ``pct_eigval_energy``
    of the squared-eigenvalue energy (at least 2, chnmf.m:94-95),
    projects V onto each pair of them, takes the 2-D convex hull of each
    projection, and collects the distinct hull columns of V, ordered as
    MATLAB's unique(S', 'rows') orders them (chnmf.m:102).  For m <= 1024
    the eigenpairs are exact (``torch.linalg.eigh`` of the covariance);
    above, randomized (:func:`_randomized_spectrum`, at most
    ``max_eigvecs``, probes from ``seed``).  Only the (n, E) projections
    and a 64-row head of S go to the host.  ``V`` is a tensor or an
    array, which goes to ``device`` (default: the card).
    """
    V = as_tensor(V, resolve_dtype(V, None), resolve_device(V, device))
    m, n = V.shape
    if m == 1:  # chnmf.m:87-89
        return torch.stack((torch.min(V), torch.max(V)))[None, :]
    if n <= 2:  # chcnmf.m:101-102
        return V

    num_request = int(min(max_eigvecs, m, n - 1))
    if m <= 1024:
        # The energy rule runs over the full spectrum, as the reference's.
        vals_d, vecs = _top_eigvecs_exact(V)
        total_sq = float(torch.sum(vals_d ** 2))
    else:
        vals_d, vecs, tsq = _randomized_spectrum(V, num_request, int(seed), 4)
        total_sq = float(tsq)
    vals = vals_d.cpu().numpy()

    # First index whose cumulative squared-eigenvalue energy exceeds the
    # threshold (chnmf.m:94-95), at least 2, at most the computed pairs.
    cum = np.cumsum(vals ** 2) / max(total_sq, np.finfo(vals.dtype).tiny)
    above = np.nonzero(cum > pct_eigval_energy)[0]
    keep = int(above[0] + 1) if above.size else vals.shape[0]
    keep = min(max(keep, 2), vals.shape[0])

    proj_all = (V.T @ vecs[:, :keep]).cpu().numpy()
    idx_set: set[int] = set()
    for e1 in range(keep - 1):
        for e2 in range(e1 + 1, keep):
            idx_set.update(_convhull_2d(proj_all[:, [e1, e2]]).tolist())
    # Distinct column indices, then the value-lexicographic column order
    # of unique(S', 'rows') from a row head of S (the full columns when
    # two heads tie).
    cols = torch.as_tensor(sorted(idx_set), dtype=torch.long, device=V.device)
    S = V[:, cols]
    head = S[: min(m, 64)].cpu().numpy()
    if np.unique(head.T, axis=0).shape[0] < head.shape[1]:
        head = S.cpu().numpy()
    order = np.lexsort(head[::-1, :])  # primary key: the first row
    return S[:, torch.as_tensor(order, device=V.device)]
