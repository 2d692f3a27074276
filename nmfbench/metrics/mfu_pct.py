"""The whole iteration's share of the chips' peak: the iteration's least
FLOPs (``work.py``) times the window's iterations, over the window's
seconds times the chips times the card's published dense TF32 rate."""
UNIT = "%"


def read(run):
    if run.peak_flops is None or not run.iters or run.window_s <= 0:
        return None
    return 100.0 * run.flops_per_iter * run.iters / (run.window_s * run.chips * run.peak_flops)
