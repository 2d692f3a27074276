"""Iterations of every solve of the window over the window's seconds, from
its start to the end of its last solve (host clock)."""
UNIT = "iter/s"


def read(run):
    return run.iters / run.window_s if run.window_s > 0 else None
