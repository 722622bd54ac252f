"""The port's test suite's cap on PyTorch's CPU threads.

Every tests/test_torch_*.py imports this module, so each pytest-xdist
worker (workers collect every file before any test runs) caps torch at
its share of the cores, os.cpu_count() // PYTEST_XDIST_WORKER_COUNT
intra-op threads, and as many inter-op threads where torch still allows
setting them. Several workers at PyTorch's default of every core each
oversubscribe the machine: bf16 convolutions ran ~35x slower that way
than alone. XLA's pool is left as tests/conftest.py sets it, and the
spawned gloo ranks run on one thread each (tests/torch_parallel_ranks.py).

The modules that take test_torch_train_step.one_torch_thread stay at one
thread while they run, as before the cap. A check that depends on the
thread count runs at the counts it names with `at(n)` (DEFAULT is
PyTorch's own count): test_torch_depth_train.py's apply_train holds the
port's distance from f64 at one thread and at DEFAULT, and
test_torch_parallel_predictor.py holds its sharding at 1, 2, 4 and 8.
"""

import contextlib
import os

import torch

DEFAULT = torch.get_num_threads()
THREADS = max(1, (os.cpu_count() or 1)
              // int(os.environ.get('PYTEST_XDIST_WORKER_COUNT', '1')))
torch.set_num_threads(THREADS)
try:
    torch.set_num_interop_threads(THREADS)
except RuntimeError:        # inter-op work has started: torch keeps its pool
    pass


@contextlib.contextmanager
def at(n):
    """n intra-op threads inside the block."""
    was = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(was)
