"""Collectives per iteration: the window's change of
``nmf_toolbox_tpu_torch.parallel.collectives.calls`` on rank 0 over its
iterations; nothing to read on one chip."""
UNIT = "calls/iter"


def read(run):
    if run.chips < 2 or not run.iters:
        return None
    return run.counters["collectives"] / run.iters
