"""Dictionary post-processing and visualization (the port's copy of
``nmf_toolbox_tpu/utils/viz.py``).

Ports of the reference's L3 layer: SortDictionary.m and ViewDictionary.m
(matplotlib instead of MATLAB graphics).  Every function takes arrays or
tensors on any device (a port ``Result``'s factors) and works on host
copies; the sorted factors come back as NumPy.
"""
from __future__ import annotations

import numpy as np

from ..core import to_host


def sort_dictionary(W, H=None):
    """Sort basis elements by increasing center of mass.

    Reference: SortDictionary.m:31-47 — center of gravity is the last
    (1-based) row index where the column's cumulative sum is <= half the
    total (1 if none); H rows are reordered to match.  Like the reference,
    this does not apply to a 3-D convolutive basis (SortDictionary.m:3).

    Returns W_sorted or (W_sorted, H_sorted).
    """
    W = to_host(W)
    if W.ndim != 2:
        raise ValueError("sort_dictionary expects a 2-D basis "
                         "(doesn't work for CNMF basis)")
    csum = np.cumsum(W, axis=0)
    half = csum[-1, :] / 2.0
    below = csum <= half[None, :]
    # last True index (1-based); 1 when none (SortDictionary.m:36-41)
    any_below = below.any(axis=0)
    last_idx = W.shape[0] - 1 - np.argmax(below[::-1, :], axis=0) + 1
    cog = np.where(any_below, last_idx, 1)
    order = np.argsort(cog, kind="stable")
    W_sorted = W[:, order]
    if H is None:
        return W_sorted
    H = to_host(H)
    return W_sorted, H[order, :]


def view_dictionary(W, config: dict | None = None, ax=None, show=False,
                    **kwargs):
    """Plot an NMF (2-D) or CNMF (3-D) basis.

    Options (ViewDictionary.m:15-28): logscale (False), flipud (False),
    threshold (-inf), sort (False), spacing (1, CNMF only).  Returns the
    matplotlib Axes.
    """
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    cfg = dict(config or {})
    cfg.update(kwargs)
    logscale = bool(cfg.get("logscale", False))
    flip = bool(cfg.get("flipud", False))
    threshold = float(cfg.get("threshold", -np.inf))
    do_sort = bool(cfg.get("sort", False))
    spacing = int(cfg.get("spacing", 1))
    if spacing < 0:
        spacing = 1

    W = to_host(W)
    if W.ndim == 2:  # NMF (ViewDictionary.m:56-65)
        if do_sort:
            W = sort_dictionary(W)
        Wd = np.maximum(W, threshold)
        if logscale:
            Wd = np.log10(Wd)
    else:  # CNMF: flatten the (m, K, T) tensor with spacing columns
        m, K, T = W.shape
        Wd = np.log10(np.asarray(W)) if logscale else np.asarray(W)
        Wd = np.maximum(Wd, threshold)
        gap = np.full((m, K, spacing), -np.inf)
        # cat(3, ...) -> permute([1 3 2]) -> column-major reshape
        # (ViewDictionary.m:70-73): element (i, k, t) lands at column
        # k*(T+spacing)+t, which is a plain C-order reshape of (m, K, T+sp).
        Wd = np.concatenate([Wd, gap], axis=2)
        Wd = Wd.reshape(m, K * (T + spacing))

    if ax is None:
        _, ax = plt.subplots()
    origin = "lower" if flip else "upper"  # axis xy <-> ij
    im = ax.imshow(Wd, aspect="auto", origin=origin, interpolation="nearest")
    ax.figure.colorbar(im, ax=ax)
    ax.set_xlabel("Basis index")
    if np.asarray(W).ndim == 3:
        # relabel ticks in basis-element units, every 5 elements
        # (ViewDictionary.m:83-90)
        m, K, T = np.asarray(W).shape
        stride = T + spacing
        ticks = np.arange(round(4.5 * stride), Wd.shape[1], 5 * stride)
        ax.set_xticks(ticks)
        ax.set_xticklabels([str(5 * (j + 1)) for j in range(len(ticks))])
    if show:
        ax.figure.show()
    return ax


def view_consensus(consensus, ax=None, show=False):
    """Plot a (reordered) consensus matrix from a rank sweep.

    The standard readout of Brunet-2004 consensus clustering: samples
    are reordered by the average-linkage dendrogram of 1 - consensus so
    stable clusters appear as crisp diagonal blocks; a smeared plot
    means the candidate rank is unstable.  Pass one
    ``RankSelection.stats[i].consensus`` from
    ``nmf_toolbox_tpu_torch.consensus_stability``.

    Returns the matplotlib Axes.  (Beyond-reference surface — the
    reference has no rank-selection tooling.)
    """
    import matplotlib.pyplot as plt
    from scipy.cluster.hierarchy import linkage, leaves_list
    from scipy.spatial.distance import squareform

    C = to_host(consensus).astype(np.float64)
    if C.ndim != 2 or C.shape[0] != C.shape[1]:
        raise ValueError(f"consensus must be square; got {C.shape}")
    d = 1.0 - (C + C.T) / 2.0
    np.fill_diagonal(d, 0.0)
    if C.shape[0] > 1 and np.ptp(squareform(d, checks=False)) > 0:
        order = leaves_list(linkage(squareform(d, checks=False),
                                    method="average"))
    else:
        order = np.arange(C.shape[0])
    if ax is None:
        _, ax = plt.subplots()
    im = ax.imshow(C[np.ix_(order, order)], vmin=0.0, vmax=1.0,
                   aspect="equal", interpolation="nearest")
    ax.figure.colorbar(im, ax=ax)
    ax.set_xlabel("Sample (dendrogram order)")
    ax.set_ylabel("Sample (dendrogram order)")
    if show:
        ax.figure.show()
    return ax
