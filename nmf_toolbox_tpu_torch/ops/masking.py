"""Valid-region masks for padded problems (PyTorch counterpart of
``nmf_toolbox_tpu/ops/masking.py``).

``valid`` is the (m_valid, n_valid) of the true problem inside a
zero-padded (m, n) array, or None for the unpadded fast path.
"""
from __future__ import annotations

import torch


def region_mask(shape, valid, device=None, offset=(0, 0)):
    """(m, n) bool mask of the valid region; None when ``valid`` is None.
    A mesh rank's block passes its first row and column in the padded
    array as ``offset``: validity is a property of the global index, and
    a mask from local indices would mark the wrong entries."""
    if valid is None:
        return None
    m, n = shape[-2], shape[-1]
    mv, nv = valid
    rows = torch.arange(offset[0], offset[0] + m, device=device) < mv
    cols = torch.arange(offset[1], offset[1] + n, device=device) < nv
    return rows[:, None] & cols[None, :]


def col_mask(n: int, n_valid, device=None, offset: int = 0):
    """(n,) bool mask of the valid columns; None when ``n_valid`` is None.
    ``offset``: the block's first column, as in :func:`region_mask`."""
    if n_valid is None:
        return None
    return torch.arange(offset, offset + n, device=device) < n_valid
