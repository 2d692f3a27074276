"""Set-up: from the process's start (on a mesh, the first process's) to the
window's start: imports, the kernel library loaded (built in a checkout's
first run), V and the tolerance made, the cell's shapes warmed (host
clock)."""
UNIT = "s"


def read(run):
    return run.setup_s
