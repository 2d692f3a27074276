"""The iteration's kernels against their roofline: the least seconds of an
iteration at the card's peaks (``work.py``: FLOPs at the TF32 rate or bytes
at the HBM bandwidth, whichever is larger, over the chips) over the device's
busy seconds per iteration in the profiled solve (mean over the chips)."""
UNIT = "%"


def read(run):
    p = run.profile
    if p is None or run.least_s_per_iter is None or not p["iters"] or p["busy_s"] <= 0:
        return None
    return 100.0 * run.least_s_per_iter / (p["busy_s"] / p["iters"])
