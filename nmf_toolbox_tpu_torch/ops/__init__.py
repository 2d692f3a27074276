"""Shared numerical layer (PyTorch counterparts of ``nmf_toolbox_tpu/ops``)."""
