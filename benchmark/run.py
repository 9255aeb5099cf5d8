"""The benchmark of sondetpu_torch on an NVIDIA GPU.

Run from the root of a checkout:

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cells, configurations and metrics are listed in BENCHMARK.json; see
benchmark/README.md. The last line of standard output is the run's result
as one JSON object.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
