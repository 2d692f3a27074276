"""Run one cell of the benchmark once and print its result line.

    python3 nmfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cells, configurations, traffic mixes
and metrics are those of ``BENCHMARK.json``; see ``nmfbench/harness.py``.
"""
import time

T0 = time.time()  # set-up is counted from here

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from nmfbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t0=T0))
