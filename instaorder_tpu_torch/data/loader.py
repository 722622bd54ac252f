"""Batched, prefetching data loader on the host (counterpart of
instaorder_tpu/data/loader.py, its `thread` and `process` modes).

  * mode='thread': a thread pool maps `dataset.sample(idx, rng)` over
    the sampler's stream (numpy, zlib and the resizes' matmuls release
    the GIL for much of the work);
  * mode='process': spawn-based worker processes (the reference's
    num_workers model) for hosts where the GIL-bound share of a sample
    limits the threads. 'spawn', not fork: a worker never inherits the
    parent's CUDA context.

Each sample's RNG is seeded from its position in the stream,
(seed * 1_000_003 + pos) % (2**31 - 1), as in the JAX package, so the
batches are the same for every worker count and in both modes, and the
same as the JAX package's. A data-parallel rank's loader (rank,
world_size) holds the rank's slice of each global batch: its items take
their positions in the global stream, so that rank r's batch is the
rows of the JAX package's global batch that its mesh device r holds. A
worker's error is raised to the consumer.
The JAX package's third mode, 'grain', raises here: the grain package is
not a dependency of the port.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np

from .datasets import collate

# process-mode worker state (one dataset per worker process)
_WORKER = {}


def sample_rng(seed: int, pos: int) -> np.random.RandomState:
    """The RNG of the sample at stream position `pos`."""
    return np.random.RandomState((seed * 1_000_003 + pos) % (2 ** 31 - 1))


def _worker_init(dataset):
    _WORKER['ds'] = dataset


def _worker_sample(args):
    seed, pos, idx = args
    return _WORKER['ds'].sample(int(idx), sample_rng(seed, pos))


class DataLoader:
    def __init__(self, dataset, sampler, batch_size, num_workers=4,
                 prefetch=4, seed=0, mode='thread', rank=0, world_size=1):
        if mode == 'grain':
            raise NotImplementedError(
                "DataLoader mode='grain' is not ported: the grain package "
                "is not a dependency of instaorder_tpu_torch; use 'thread' "
                "or 'process'")
        if mode not in ('thread', 'process'):
            raise ValueError(f'unknown loader mode {mode!r}')
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.seed = seed
        self.mode = mode
        self.rank, self.world_size = rank, world_size

    def _stream_pos(self, p):
        """The global stream position of this loader's item p: rank r
        holds items r*b .. r*b + b - 1 of each global batch of
        world_size*b."""
        b = self.batch_size
        return (p // b * self.world_size + self.rank) * b + p % b

    def _make_pool(self):
        if self.mode == 'process':
            import multiprocessing as mp
            return ProcessPoolExecutor(
                self.num_workers, mp_context=mp.get_context('spawn'),
                initializer=_worker_init, initargs=(self.dataset,))
        return ThreadPoolExecutor(self.num_workers)

    def __iter__(self):
        indices = list(self.sampler)
        n_batches = len(indices) // self.batch_size
        pool = self._make_pool()
        q: queue.Queue = queue.Queue(self.prefetch)
        stop = threading.Event()

        def sample_one(pos_idx):
            pos, idx = pos_idx
            return self.dataset.sample(int(idx), sample_rng(self.seed, pos))

        def producer():
            try:
                for b in range(n_batches):
                    if stop.is_set():
                        break
                    lo, hi = b * self.batch_size, (b + 1) * self.batch_size
                    pos = [self._stream_pos(p) for p in range(lo, hi)]
                    if self.mode == 'process':
                        samples = list(pool.map(
                            _worker_sample,
                            [(self.seed, q, indices[p])
                             for q, p in zip(pos, range(lo, hi))]))
                    else:
                        samples = list(pool.map(
                            sample_one, zip(pos, indices[lo:hi])))
                    q.put(collate(samples))
                q.put(None)
            except Exception as e:  # surface worker errors to the consumer
                q.put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            # unblock a producer waiting on a full queue, then let it end
            while t.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    t.join(timeout=0.05)
            pool.shutdown(wait=True, cancel_futures=True)

    def __len__(self):
        return len(self.sampler) // self.batch_size
