"""Shared numerical layer (PyTorch counterparts of ``nmf_toolbox_tpu/ops``).

Re-exports the same names as the JAX package's ``ops``, from the port's
own modules.
"""
from .divergence import canon, ab_params, fields, ab_fields, apply_power, cost
from .shift import (shift_left, shift_right, stack_shifts_right, reconstruct,
                    conv_reconstruct, conv_wt_phi, conv_phi_ht)
from .normalize import (unit_l2_columns, unit_sum_columns, row_l2_transfer,
                        cross_frame_norm)
from .projection import project_columns, projfunc, hoyer_l1_target
from .gram import pos_neg_split, sq_norm, euclidean_cost_gram, euclidean_cost_gram_w
from . import loop

__all__ = [
    "canon", "ab_params", "fields", "ab_fields", "apply_power", "cost",
    "shift_left", "shift_right", "stack_shifts_right", "reconstruct",
    "conv_reconstruct", "conv_wt_phi", "conv_phi_ht",
    "unit_l2_columns", "unit_sum_columns", "row_l2_transfer", "cross_frame_norm",
    "project_columns", "projfunc", "hoyer_l1_target",
    "pos_neg_split", "sq_norm", "euclidean_cost_gram", "euclidean_cost_gram_w",
    "loop",
]
