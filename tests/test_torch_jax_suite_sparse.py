"""The JAX package's tests of the projection, the sparse solvers, the
batched line search, the phased nmfsc dispatch and its fuzzing, and
regression tests, against the port on the CPU (tests/torch_jax_suite.py)."""
from torch_jax_suite import JAX_INTERNALS, JAX_ONLY, MESH, suite

globals().update(suite({
    "test_projection": {},
    "test_sparse_solvers": {},
    "test_linesearch_batched": {
        "test_batched_mesh_composes": MESH,
        "test_resolve_width_auto": MESH + "; it also patches jax.default_backend",
    },
    "test_nmfsc_phased": {"test_phased_rejects_mesh": MESH},
    "test_fuzz_phased": {},
    "test_review_fixes": {
        "test_cli_streaming_init_and_inner_flags": JAX_ONLY.format("its CLI, in a subprocess"),
        "test_save_factors_initializes_no_backend": JAX_ONLY.format("in a subprocess"),
        "test_solver_marginal_sweep_flag_only_argv": JAX_ONLY.format(
            "benchmarks/solver_marginal_sweep.py"),
        "test_hull_and_nndsvd_rank_deficient_input": JAX_INTERNALS.format(
            "utils.init._randomized_spectrum, called on jax.numpy arrays"),
        "test_save_factors_multiprocess_guard": JAX_INTERNALS.format(
            "jax.distributed's process count"),
    },
}))
