"""A rank process of the harness with a fault planted first (tests only).

    python fault_rank.py <fault> <the rank's run.py arguments>

``no_exchange``: every ``all_reduce`` the program issues returns its
input unchanged, as if the exchange between the ranks were left out."""
import sys
import time
from pathlib import Path

T0 = time.time()
ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def no_exchange():
    import torch.distributed as dist
    dist.all_reduce = lambda tensor, *a, **k: None


if __name__ == "__main__":
    fault, argv = sys.argv[1], sys.argv[2:]
    from nmfbench import harness
    {"no_exchange": no_exchange}[fault]()
    sys.exit(harness.main(argv, root=ROOT, t0=T0))
