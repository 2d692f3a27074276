"""Multi-device layer (PyTorch counterpart of ``nmf_toolbox_tpu/parallel``):
one process per device over ``torch.distributed``; the same names as the
JAX package's ``parallel``."""
from .mesh import (make_mesh, shard, replicate, col_sharding, row_sharding,
                   grid_sharding, placements_for, apply_placements,
                   init_distributed)
from .padding import (mesh_multiples, pad_amount, pad_axes, plan_padding,
                      prepare_weights)

__all__ = ["make_mesh", "shard", "replicate", "col_sharding", "row_sharding",
           "grid_sharding", "placements_for", "apply_placements",
           "init_distributed", "mesh_multiples", "pad_amount", "pad_axes",
           "plan_padding", "prepare_weights"]
