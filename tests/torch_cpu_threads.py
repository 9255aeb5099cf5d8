"""One intra-op thread for torch in the port's CPU tests.

The suite runs in parallel worker processes (pytest-xdist), and torch
would start one OpenMP thread per core in each of them: with six workers
on 8 cores the threads outnumber the cores and spin while they wait. The
port's tests then took 998 s against 110 s with one thread each (338
tests, six workers, 8 cores). Every tests/test_torch_*.py that runs on
the CPU imports this module first; the environment variable carries the
setting into the subprocesses the tests start.
"""

import os

import torch

os.environ["OMP_NUM_THREADS"] = "1"
torch.set_num_threads(1)
