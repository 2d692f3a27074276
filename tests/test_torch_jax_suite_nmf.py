"""The JAX package's tests of nmf, HALS, NNDSVD, cost_every, the
accelerated and compatibility options and edge shapes, run against the
port on the CPU (tests/torch_jax_suite.py)."""
from torch_jax_suite import JAX_INTERNALS, MESH, SEEDED, TORCH_ARGS, suite

globals().update(suite({
    "test_nmf": {},
    "test_hals": {"test_hals_early_stop_and_mesh": SEEDED},
    "test_nndsvd": {"test_init_nndsvd_preserves_product_through_renorm":
                    TORCH_ARGS.format("PRNGKey (key=)", "Generator (generator=)")},
    "test_cost_every": {"test_segmented_equals_cond_fallback": JAX_INTERNALS.format(
        "models.batched._SEGMENT_MAX_CHECKS and its jit caches")},
    "test_accel": {"test_inner_composes_with_mesh": MESH},
    "test_compat_mode": {},
    "test_edge_shapes": {},
}))
