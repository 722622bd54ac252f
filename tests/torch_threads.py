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
thread while they run, as before the cap: on an 8-core CPU
test_torch_depth_train.py's apply_train forwards miss their 1e-5 bar by
0.7% and 7.2% at eight threads. A comparison whose bar holds only at
some thread counts runs inside `default()`: at PyTorch's own count, as
before the cap.
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
def default():
    """PyTorch's default intra-op thread count inside the block."""
    n = torch.get_num_threads()
    torch.set_num_threads(DEFAULT)
    try:
        yield
    finally:
        torch.set_num_threads(n)
