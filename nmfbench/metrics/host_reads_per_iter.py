"""Values the convergence loop brings to the host per iteration: the
window's change of ``nmf_toolbox_tpu_torch.core.host_reads`` over its
iterations (rank 0's on a mesh)."""
UNIT = "reads/iter"


def read(run):
    return run.counters["host_reads"] / run.iters if run.iters else None
