"""The device's idle share over the profiled solve: one minus its busy
seconds (the union of its operations, from the trace) over the solve's
seconds by the host clock."""
UNIT = "%"


def read(run):
    p = run.profile
    if p is None or p["window_s"] <= 0 or p["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
