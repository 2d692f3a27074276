"""The JAX package's property sweeps, configuration fuzzing, goldens and
public-API tests, run against the port on the CPU
(tests/torch_jax_suite.py)."""
from torch_jax_suite import suite

globals().update(suite({
    "test_properties_sweep": {},
    "test_fuzz_configs": {},
    "test_goldens": {},
    "test_api": {},
}))
