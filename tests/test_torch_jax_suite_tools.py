"""The JAX package's tests of the CLI, the estimator, the ops' units,
the kernels' plain versions, io and native, the device probe and the
advisor fixes, against the port on the CPU
(tests/torch_jax_suite.py): the CLI's subprocess runs become runs of the
port's CLI in process, ``ops.pallas`` the port's ``ops.kernels``.  The
tests that drive only the JAX package, hand it a JAX mesh or reach into
its internals are left out by name, each with its reason."""
from torch_jax_suite import JAX_INTERNALS, JAX_ONLY, MESH, TORCH_ARGS, suite

globals().update(suite({
    "test_cli": {"test_cli_mesh": MESH + "; it runs the CLI with --mesh 8 over XLA's "
                                         "virtual devices",
                 "test_cli_pick_rank_mesh_rounds_seeds": MESH + "; it runs the CLI with "
                                                                "--mesh 8"},
    "test_estimators": {},
    "test_ops_units": {},
    "test_pallas": {},
    "test_native": {},
    "test_deviceprobe": {},
    "test_advice_fixes": {"test_randomized_svd_uses_operand_eps": TORCH_ARGS.format(
        "dtype and PRNGKey (key=)", "dtype and Generator (generator=)")},
    "test_tpu_emulation": {name: JAX_INTERNALS.format(
        "utils.debug.emulate_tpu_matmul_numerics, the TPU's bf16 matrix unit under XLA_FLAGS; "
        "tests/test_torch_debug.py holds the port's emulate_card_matmul_numerics to its checks")
        for name in ("test_guard_raises_without_xla_flag",
                     "test_emulation_numerics_subprocess")},
    "test_examples": {"test_example_runs": JAX_ONLY.format(
        "examples/*.py, each loaded with the JAX package's own imports")},
    "test_transcribe_results": {name: JAX_ONLY.format(
        "benchmarks/transcribe_results.py, in a subprocess") for name in (
        "test_tpu_bench_row_retitles_and_folds", "test_cpu_fallback_row_does_not_retitle",
        "test_idempotent_rerun_replaces_section")},
}))

