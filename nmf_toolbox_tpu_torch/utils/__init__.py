"""Utilities (PyTorch counterparts of ``nmf_toolbox_tpu/utils``)."""
from .audio import griffinlim, hann_window, istft, magnitude, stft
from .init import convex_hull_anchors, kmeans, kmeans_indicator_h, nndsvd, seedable
from .separation import separate, separate_waveforms, wiener_masks

__all__ = ["nndsvd", "seedable", "kmeans", "kmeans_indicator_h",
           "convex_hull_anchors", "wiener_masks", "separate",
           "separate_waveforms", "stft", "istft", "hann_window", "magnitude",
           "griffinlim"]
