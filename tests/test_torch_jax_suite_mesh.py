"""The JAX package's tests of mesh=, padded meshes, sharded checkpoints
and jax.distributed, against the port on the CPU
(tests/torch_jax_suite.py).  Each test that hands the port a JAX mesh is
left out by name (MESH): tests/test_torch_parallel*.py,
test_torch_checkpoint_orbax.py and test_torch_distributed.py hold the
port's own meshes of Gloo ranks against the JAX package's."""
from torch_jax_suite import MESH, suite

globals().update(suite({
    "test_parallel": dict.fromkeys((
        "test_nmf_sharded_matches_single", "test_nmf_sharded_2d_mesh",
        "test_cnmf_sharded_halo", "test_other_solvers_sharded", "test_convexnmf_sharded",
        "test_cmfwisa_sharded", "test_placement_tables_complete", "test_chnmf_sharded",
        "test_chcnmf_sharded", "test_cnmfsc_sharded", "test_constrainednmf_sharded",
        "test_multiseed_sharded", "test_consensus_sweep_on_mesh",
        "test_multiseed_kl_sharded_padded"), MESH),
    "test_parallel_padded": dict.fromkeys((
        "test_plan_padding", "test_nmf_padded", "test_lnmf_padded", "test_seminmf_padded",
        "test_convexnmf_padded", "test_chnmf_padded_2d_mesh", "test_chcnmf_padded_2d_mesh",
        "test_cnmf_padded", "test_nmfsc_padded", "test_cnmfsc_padded",
        "test_cmfwisa_padded_2d_mesh", "test_constrainednmf_padded",
        "test_padded_default_inits_match"), MESH),
    "test_checkpoint_orbax": dict.fromkeys((
        "test_sharded_save_and_placement_restore", "test_run_checkpointed_orbax_matches_npz",
        "test_run_checkpointed_orbax_crash_resume",
        "test_auto_backend_selects_orbax_for_mesh_dir"), MESH),
    "test_distributed_multiproc": {"test_two_process_mesh_parity": MESH + "; it runs "
                                   "benchmarks/distributed_multiproc.py's jax.distributed "
                                   "processes"},
}))
