"""Utilities (PyTorch counterparts of ``nmf_toolbox_tpu/utils``)."""
from .init import convex_hull_anchors, kmeans, kmeans_indicator_h, nndsvd, seedable

__all__ = ["nndsvd", "seedable", "kmeans", "kmeans_indicator_h",
           "convex_hull_anchors"]
