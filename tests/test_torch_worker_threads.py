"""An equal share of the cores for torch in each pytest-xdist worker.

The tier-1 command (ROADMAP.md) runs the suite in six xdist worker
processes.  torch's intra-op pool takes every core in each of them, and its
OpenMP threads wait by spinning, so six workers kept six times the cores
busy: on an 8-core CPU, ``test_torch_run_alpaca.py``'s fixture took 929 s
under the six workers against 15-25 s alone, six concurrent runs of
``test_torch_run_glue.py`` 166 s against 14 s with one thread each, and the
whole command ran past its time limit.  Here each worker takes
``cores // workers`` torch threads (at least one) when this module is
collected; every xdist worker collects every file before any test runs, so
every test of such a run sees it.  A run in one process keeps torch's
default.  Only the time changes: the tests compare within tolerances, or
two computations of one process, which share its thread count.
"""

import os

import torch

WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
CORES = len(os.sched_getaffinity(0))
if WORKERS > 1:
    torch.set_num_threads(max(1, CORES // WORKERS))


def test_torch_xdist_workers_share_the_cores():
    want = max(1, CORES // WORKERS) if WORKERS > 1 else torch.get_num_threads()
    assert torch.get_num_threads() == want >= 1
