"""Rank (number of basis elements) selection for NMF.

PyTorch counterpart of ``nmf_toolbox_tpu/rank.py``.  The reference leaves
``num_basis_elems`` to the user (nmf.m:1); this module gives the two
standard data-driven answers:

1. **Spectral energy** (`estimate_rank_svd`): the smallest k whose
   truncated spectrum captures a target fraction of ||V||_F^2, from the
   randomized SVD of ``utils/init.py`` (V touched only through matmuls),
   in memory or streamed from the host in column blocks.

2. **Consensus / stability** (`consensus_stability`, Brunet et al. 2004,
   PNAS): for each candidate k, factorize from many random restarts
   (``nmf_multiseed``: one batched solve, V shared) and measure how
   consistently pairs of columns cluster together.  The connectivity is
   built on the device — one-hot labels from the argmax over each
   restart's H, then one (n, n) product summed over the restarts — and
   only the (n, n) consensus goes to scipy for the cophenetic
   correlation.

`pick_rank` is the front door combining both.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core import as_tensor, merge_config, resolve_device, resolve_dtype, staging_device
from .models.batched import nmf_multiseed
from .utils.init import _cholesky_qr, _randomized_svd, _working_eps


@dataclasses.dataclass
class RankStats:
    """Stability statistics for one candidate rank."""
    rank: int
    cophenetic: float      # cophenetic correlation of the consensus (1 = stable)
    dispersion: float      # Kim & Park 2007 dispersion of the consensus (1 = crisp)
    consensus: np.ndarray  # (n, n) mean connectivity over restarts
    mean_cost: float       # mean final objective over restarts
    best_cost: float       # best final objective over restarts


@dataclasses.dataclass
class RankSelection:
    """Outcome of a rank sweep.  ``stats`` is ordered as ``ranks``."""
    recommended: int
    ranks: tuple[int, ...]
    stats: list[RankStats]
    method: str


def _consensus_metrics(consensus: np.ndarray) -> tuple[float, float]:
    """(cophenetic correlation, dispersion) of a consensus matrix.

    Cophenetic: average-linkage dendrogram of the dissimilarity
    1 - consensus, correlated against the original dissimilarities
    (Brunet 2004 supplement).  Dispersion: rho = mean(4*(C - 1/2)^2)
    (Kim & Park 2007) — 1 iff every entry is exactly 0 or 1.
    """
    n = consensus.shape[0]
    disp = float(np.mean(4.0 * (consensus - 0.5) ** 2))
    d = 1.0 - consensus
    # Zero-variance guard (scipy's cophenet returns nan there): a
    # UNIFORM dissimilarity near 0 (always one cluster) or near 1
    # (always all-separate) is perfectly consistent -> 1; a uniform
    # mid-value (e.g. 0.5 everywhere: coin-flip co-clustering) is
    # maximal instability -> 0.
    iu = np.triu_indices(n, k=1)
    dv = d[iu]
    if np.allclose(dv, dv[0] if dv.size else 0.0):
        v = float(dv[0]) if dv.size else 0.0
        return (1.0 if (v <= 0.05 or v >= 0.95) else 0.0), disp
    from scipy.cluster.hierarchy import cophenet, linkage
    from scipy.spatial.distance import squareform
    dv_sym = squareform((d + d.T) / 2.0, checks=False)
    Z = linkage(dv_sym, method="average")
    coph, _ = cophenet(Z, dv_sym)
    return float(coph), disp


def _consensus(H) -> np.ndarray:
    """Mean connectivity over restarts, (n, n) float64: entry (i, j) is the
    share of restarts whose H (S, k, n) gives columns i and j their
    largest entry in the same row (the first such row on ties, as
    ``np.argmax``).  Computed on H's device as X X' with X the (n, S*k)
    one-hot labels, exact in f32 (counts up to S < 2**24)."""
    S, k, n = H.shape
    labels = torch.argmax(H, dim=1)                              # (S, n)
    X = torch.nn.functional.one_hot(labels, k).to(torch.float32)  # (S, n, k)
    X = X.permute(1, 0, 2).reshape(n, S * k)
    return (X @ X.T).cpu().numpy().astype(np.float64) / S


def _curve_rank(s, total, energy, k):
    """(rank, curve) from singular values ``s`` (NumPy, f64) and the exact
    ||V||_F^2.  Clipped at 1: the randomized spectrum can overestimate
    individual singular values by O(eps * s_1), pushing the cumulative
    sum a hair past the exact total."""
    curve = np.minimum(np.cumsum(s ** 2)
                       / max(total, np.finfo(np.float64).tiny), 1.0)
    hit = np.nonzero(curve >= energy)[0]
    return (int(hit[0]) + 1 if hit.size else k), curve


def estimate_rank_svd(V, energy: float = 0.90, max_rank: int = 64,
                      seed: int = 0, dtype=None, block_size=None,
                      device=None):
    """Smallest k capturing ``energy`` of ||V||_F^2, from a randomized SVD.

    Returns (rank, energy_curve) where energy_curve[i] is the fraction
    captured by the top i+1 singular values.  If even ``max_rank``
    components fall short (heavy-tailed spectrum), returns ``max_rank``.

    ``device``: where a NumPy ``V`` (or, streamed, each block) goes
    (default: the CUDA card; pass ``"cpu"`` to run on the CPU); a tensor
    ``V`` runs on its own device.  The sketch comes from a CPU
    ``torch.Generator`` seeded with ``seed``, so it differs from the JAX
    package's; the curve does not depend on it where V's rank is below
    ``max_rank``.

    ``block_size``: OUT-OF-CORE mode — V (e.g. a memory-mapped .npy, or a
    tensor in host memory) is streamed in column blocks and only (m, p)
    / (p, p) arrays ever exist on the device (p = max_rank +
    oversampling); see :func:`_estimate_rank_svd_streaming`.
    """
    if not (0.0 < energy <= 1.0):
        raise ValueError(f"energy must be in (0, 1]; got {energy}")
    if block_size is not None:
        return _estimate_rank_svd_streaming(V, energy, max_rank, seed,
                                            dtype, int(block_size), device)
    V = as_tensor(V, resolve_dtype(V, dtype), resolve_device(V, device))
    m, n = V.shape
    k = int(min(max_rank, m, n))
    with torch.no_grad():
        _, s, _ = _randomized_svd(torch.Generator().manual_seed(int(seed)), V, k)
        # ||V||_F^2 exactly (one device reduction, bf16 accumulated in
        # f32), instead of trusting the truncated spectrum's tail.
        acc = torch.float32 if V.dtype == torch.bfloat16 else V.dtype
        total = float(torch.sum(torch.square(V.to(acc))))
    return _curve_rank(s.cpu().numpy().astype(np.float64), total, energy, k)


def _estimate_rank_svd_streaming(V, energy, max_rank, seed, dtype, block,
                                 device, oversample=10, power_iters=2):
    """Blockwise randomized spectrum (Halko 2011 structure, one column-
    block stream per stage).  The (n, p) sketch of the in-memory path is
    replaced by its (p, p) Gram: with Z = V'Q accumulated per block,
    qr(Z) = Z R^{-1} where R'R = Z'Z (Cholesky), so the next range
    sketch V (Z R^{-1}) = (sum_b V_b Z_b) R^{-1} needs only the blockwise
    products — nothing n-sized exists on the device."""
    m, n = V.shape
    dtype = resolve_dtype(V[:, :1] if torch.is_tensor(V) else np.asarray(V[:, :1]), dtype)
    if device is None and torch.is_tensor(V):
        device = V.device
    device = resolve_device(None, device)  # where the blocks go
    k = int(min(max_rank, m, n))
    p = int(min(k + oversample, m, n))
    eps = _working_eps(dtype)
    gen = torch.Generator().manual_seed(int(seed))
    starts = range(0, n, block)

    def blocks():
        for a in starts:
            Vb = V[:, a:min(a + block, n)]
            # np.array copies, so a read-only memory map is never aliased
            yield as_tensor(Vb if torch.is_tensor(Vb) else np.array(Vb), dtype, device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    with torch.no_grad():
        # Range sketch Y = V @ Omega, Omega's rows drawn block by block.
        Y, total = zeros(m, p), zeros()
        for Vb in blocks():
            Om_b = torch.randn((Vb.shape[1], p), generator=gen, dtype=dtype)
            Y += Vb @ Om_b.to(device)
            total += torch.sum(torch.square(Vb))  # exact ||V||_F^2
        Q = _cholesky_qr(Y, eps)

        for _ in range(power_iters):
            # One pass accumulates P = V (V'Q) and the Gram S = (V'Q)'(V'Q);
            # the orthonormalized step is P R^{-1} with R = chol(S).
            P, S = zeros(m, p), zeros(p, p)
            for Vb in blocks():
                Zb = Vb.T @ Q
                P += Vb @ Zb
                S += Zb.T @ Zb
            R = torch.linalg.cholesky(
                S + eps * torch.trace(S) * torch.eye(p, dtype=dtype, device=device),
                upper=True)
            Q = _cholesky_qr(torch.linalg.solve_triangular(R, P, upper=True,
                                                           left=False), eps)

        # Spectrum from M = (Q'V)(Q'V)' accumulated blockwise (p, p).
        M = zeros(p, p)
        for Vb in blocks():
            Bb = Q.T @ Vb
            M += Bb @ Bb.T
        vals = torch.linalg.eigh(M)[0].flip(0)
    s = np.sqrt(np.maximum(vals[:k].cpu().numpy().astype(np.float64), 0.0))
    return _curve_rank(s, float(total), energy, k)


def consensus_stability(V, ranks, n_seeds: int = 20,
                        stability_tol: float = 0.01,
                        cost_gain: float = 0.2,
                        config: dict | None = None, **kwargs) -> RankSelection:
    """Brunet-style consensus sweep over candidate ``ranks``.

    For each k: ``n_seeds`` NMF restarts (euclidean by default;
    ``divergence='kl'`` for Brunet's original objective) in one batched
    solve, connectivity C_s[i,j] = 1 iff columns i,j take their argmax on
    the same basis element, consensus = mean_s C_s (:func:`_consensus`),
    then cophenetic correlation + dispersion of the consensus.

    Recommendation rule (stability + fit elbow): among candidates whose
    cophenetic correlation is within ``stability_tol`` of the best,
    start from the smallest and move to a larger stable candidate only
    while it improves the best-restart objective by at least
    ``cost_gain`` (relative).  Pure cophenetic argmax cannot separate
    NESTED stable clusterings (merging two true clusters the same way
    every restart is also perfectly stable); the fit elbow is the
    standard discriminator (Brunet 2004 choose-before-the-drop practice,
    Hutchins 2008 residual elbow).

    kwargs are forwarded to ``nmf_multiseed`` (maxiter, default 200 here,
    seed, dtype, eps, device, mesh, ...).
    """
    cfg = merge_config(config, kwargs)
    cfg.setdefault("maxiter", 200)
    ranks = tuple(int(k) for k in ranks)
    if not ranks:
        raise ValueError("ranks must be a non-empty sequence")
    # Move V to the run's device once (under a mesh, where each rank's
    # blocks are cut from); every candidate then reuses it.
    mesh = cfg.get("mesh")
    device = resolve_device(V, cfg.get("device"), mesh)
    V = as_tensor(V, resolve_dtype(V, cfg.get("dtype")),
                  staging_device(V, device, mesh))
    stats: list[RankStats] = []
    for k in ranks:
        res = nmf_multiseed(V, k, n_seeds, dict(cfg))
        consensus = _consensus(res.H)
        coph, disp = _consensus_metrics(consensus)
        final = res.cost[:, -1]
        stats.append(RankStats(rank=k, cophenetic=coph, dispersion=disp,
                               consensus=consensus,
                               mean_cost=float(np.mean(final)),
                               best_cost=float(np.min(final))))
    best = _recommend(ranks, stats, stability_tol, cost_gain)
    return RankSelection(recommended=ranks[best], ranks=ranks, stats=stats,
                         method="consensus")


def _recommend(ranks, stats, stability_tol: float, cost_gain: float) -> int:
    """Index of the recommended candidate (stability + fit elbow)."""
    order = sorted(range(len(ranks)), key=lambda i: ranks[i])
    max_coph = max(s.cophenetic for s in stats)
    stable = [i for i in order
              if stats[i].cophenetic >= max_coph - stability_tol]
    best = stable[0]
    floor = np.finfo(np.float64).tiny
    for i in stable[1:]:
        if 1.0 - stats[i].best_cost / max(stats[best].best_cost,
                                          floor) >= cost_gain:
            best = i
        else:
            # Stop at the first non-improving stable candidate: a gentle
            # monotone cost slope must not ratchet past the elbow by
            # accumulating sub-threshold gains across candidates.
            break
    return best


def pick_rank(V, ranks=None, method: str = "consensus", **kwargs):
    """Pick ``num_basis_elems`` for V.

    method="consensus" (default): stability sweep over ``ranks``
    (required) -> RankSelection.  method="svd": spectral-energy estimate
    (kwargs: energy, max_rank, seed, dtype, block_size, device) ->
    RankSelection with empty stats and the energy curve attached as
    ``.energy_curve``.
    """
    if method == "consensus":
        if ranks is None:
            raise ValueError("consensus rank selection needs candidate ranks")
        return consensus_stability(V, ranks, **kwargs)
    if method == "svd":
        rank, curve = estimate_rank_svd(V, **kwargs)
        sel = RankSelection(recommended=rank,
                            ranks=tuple(range(1, len(curve) + 1)),
                            stats=[], method="svd")
        sel.energy_curve = curve  # type: ignore[attr-defined]
        return sel
    raise ValueError(f"unknown rank-selection method {method!r}")
