"""Time to tolerance: the window's solves' seconds, each from the call to
its return, summed, over their count (host clock)."""
UNIT = "s"


def read(run):
    if not run.solves:
        return None
    return sum(s["seconds"] for s in run.solves) / len(run.solves)
