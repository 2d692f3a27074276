"""Utilities (PyTorch counterparts of ``nmf_toolbox_tpu/utils``)."""
from .audio import griffinlim, hann_window, istft, magnitude, stft
from .checkpoint import load_factors, run_checkpointed, save_factors
from .checkpoint_orbax import load_factors_orbax, save_factors_orbax, wait_for_saves
from .init import convex_hull_anchors, kmeans, kmeans_indicator_h, nndsvd, seedable
from .io import load_matrix, save_matrix
from .separation import separate, separate_waveforms, wiener_masks
from .viz import sort_dictionary, view_consensus, view_dictionary

__all__ = ["kmeans", "kmeans_indicator_h", "convex_hull_anchors", "nndsvd",
           "sort_dictionary", "view_dictionary", "view_consensus",
           "save_factors", "load_factors", "run_checkpointed",
           "save_factors_orbax", "load_factors_orbax", "wait_for_saves",
           "load_matrix", "save_matrix", "wiener_masks", "separate",
           "separate_waveforms",
           "stft", "istft", "hann_window", "magnitude", "griffinlim"]
