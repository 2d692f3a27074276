"""The JAX package's tests of the convolutive, complex, constrained,
Gram/MU and symmetric solvers, weights, separation, audio, the
utilities and the checkpointed run, against the port on the CPU
(tests/torch_jax_suite.py)."""
from torch_jax_suite import JAX_INTERNALS, MESH, SEEDED, TORCH_ARGS, suite

globals().update(suite({
    "test_cnmf": {},
    "test_nmf2d": {"test_recovers_planted_2d_structure": SEEDED,
                   "test_mesh_matches_single_device": MESH},
    "test_complex_and_constrained": {},
    "test_simple_solvers": {
        "test_kmeans_basic": TORCH_ARGS.format("PRNGKey", "Generator"),
        "test_convexnmf_nonneg_matches_general_path": JAX_INTERNALS.format(
            "convexnmf's solver builder, called on jax.numpy arrays"),
    },
    "test_symnmf": {"test_mesh_matches_single_device": MESH},
    "test_weighted": {"test_weighted_composes_with_mesh": MESH,
                      "test_cnmf_weighted_validation_and_mesh": MESH},
    "test_separation": {},
    "test_audio": {
        "test_window_matches_scipy": TORCH_ARGS.format("dtype", "dtype"),
        "test_griffinlim_spectral_convergence": TORCH_ARGS.format("PRNGKey (key=)",
                                                                  "Generator (generator=)"),
    },
    "test_utils": {},
    "test_checkpointed_run": {},
}))
