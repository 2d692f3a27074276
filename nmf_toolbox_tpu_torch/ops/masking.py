"""Valid-region masks for padded problems (PyTorch counterpart of
``nmf_toolbox_tpu/ops/masking.py``).

``valid`` is the (m_valid, n_valid) of the true problem inside a
zero-padded (m, n) array, or None for the unpadded fast path.
"""
from __future__ import annotations

import torch


def region_mask(shape, valid, device=None):
    """(m, n) bool mask of the valid region; None when ``valid`` is None."""
    if valid is None:
        return None
    m, n = shape[-2], shape[-1]
    mv, nv = valid
    rows = torch.arange(m, device=device) < mv
    cols = torch.arange(n, device=device) < nv
    return rows[:, None] & cols[None, :]


def col_mask(n: int, n_valid, device=None):
    """(n,) bool mask of the valid columns; None when ``n_valid`` is None."""
    if n_valid is None:
        return None
    return torch.arange(n, device=device) < n_valid
