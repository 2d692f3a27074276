"""The JAX package's tests of the batched engines, rank selection and
streaming, against the port on the CPU (tests/torch_jax_suite.py)."""
from torch_jax_suite import DEVICE_OUTPUT, MESH, SEEDED, suite

globals().update(suite({
    "test_batched": {
        "test_batched_sharded_matches_single_device": MESH,
        "test_encode_sharded_matches_single_device": MESH,
        "test_conv_encode_sharded_and_validation": MESH,
        "test_encode_mesh_divisibility_error": MESH,
        "test_encode_weighted_sharded_matches_single_device": MESH,
        "test_cmfwisa_encode_sharded_and_validation": MESH,
        "test_nmf2d_encode_sparsity_sharded_validation": MESH,
        "test_device_output": DEVICE_OUTPUT,
        "test_encode_validation_and_device_output": DEVICE_OUTPUT,
    },
    "test_rank": {},
    "test_streaming": {
        "test_streaming_approximates_batch": SEEDED,
        "test_streaming_from_memmap": SEEDED,
        "test_streaming_early_stop": SEEDED,
        "test_streaming_mesh_matches_single_device": MESH,
        "test_encode_streaming_weighted_and_validation": MESH,
    },
}))
