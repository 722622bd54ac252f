"""Batched, prefetching data loader on the host (counterpart of
instaorder_tpu/data/loader.py).

  * mode='thread': a thread pool maps `dataset.sample(idx, rng)` over
    the sampler's stream (numpy, zlib and the resizes' matmuls release
    the GIL for much of the work);
  * mode='process': spawn-based worker processes (the reference's
    num_workers model) for hosts where the GIL-bound share of a sample
    limits the threads. 'spawn', not fork: a worker never inherits the
    parent's CUDA context;
  * mode='grain': grain.python.DataLoader (imported at call time; its
    worker processes, per-process sharding and checkpointable iterators)
    over a data source whose record b is the whole batch b, so that
    grain's sharding of records across its workers moves whole batches
    and keeps each batch's composition; its deterministic output order
    keeps the batches' order. Without the grain package it raises an
    ImportError that names it; it never falls back to threads.

Each sample's RNG is seeded from its position in the stream,
(seed * 1_000_003 + pos) % (2**31 - 1), as in the JAX package, so the
batches are the same for every worker count and mode, and the same as
the JAX package's. A data-parallel rank's loader
(rank, world_size) holds the rank's slice of each global batch: its
items take their positions in the global stream, so that rank r's batch
is the rows of the JAX package's global batch that its mesh device r
holds. A worker's error is raised to the consumer.
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


def _grain():
    """grain.python, or an ImportError that names it."""
    try:
        import grain.python as gp
    except ImportError as e:
        raise ImportError(
            "DataLoader mode='grain' needs the grain package, which is not "
            "installed here; use mode='thread' or 'process'") from e
    return gp


class _BatchSource:
    """grain's data source in mode='grain': record b is batch b, its
    samples drawn at their stream positions with sample_rng, collated.
    Module-level so that grain's worker processes can unpickle it."""

    def __init__(self, dataset, batches, seed):
        self._ds = dataset
        self._batches = batches       # [(stream positions, indices)]
        self._seed = seed

    def __len__(self):
        return len(self._batches)

    def __getitem__(self, b):
        pos, idx = self._batches[int(b)]
        return collate([self._ds.sample(int(i), sample_rng(self._seed, q))
                        for q, i in zip(pos, idx)])


class DataLoader:
    def __init__(self, dataset, sampler, batch_size, num_workers=4,
                 prefetch=4, seed=0, mode='thread', rank=0, world_size=1):
        if mode not in ('thread', 'process', 'grain'):
            raise ValueError(f'unknown loader mode {mode!r}')
        if mode == 'grain':
            _grain()
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

    def _batches(self):
        """[(stream positions, sampler indices)] of each whole batch."""
        indices = list(self.sampler)
        b = self.batch_size
        return [([self._stream_pos(p) for p in range(k * b, (k + 1) * b)],
                 indices[k * b:(k + 1) * b])
                for k in range(len(indices) // b)]

    def _iter_grain(self):
        gp = _grain()
        batches = self._batches()
        if not batches:
            return
        loader = gp.DataLoader(
            data_source=_BatchSource(self.dataset, batches, self.seed),
            sampler=gp.IndexSampler(
                num_records=len(batches), shard_options=gp.NoSharding(),
                shuffle=False, num_epochs=1),
            worker_count=self.num_workers,
            read_options=gp.ReadOptions(
                prefetch_buffer_size=max(self.prefetch, self.num_workers)))
        yield from loader

    def _make_pool(self):
        if self.mode == 'process':
            import multiprocessing as mp
            return ProcessPoolExecutor(
                self.num_workers, mp_context=mp.get_context('spawn'),
                initializer=_worker_init, initargs=(self.dataset,))
        return ThreadPoolExecutor(self.num_workers)

    def __iter__(self):
        if self.mode == 'grain':
            yield from self._iter_grain()
            return
        batches = self._batches()
        pool = self._make_pool()
        q: queue.Queue = queue.Queue(self.prefetch)
        stop = threading.Event()

        def sample_one(pos_idx):
            pos, idx = pos_idx
            return self.dataset.sample(int(idx), sample_rng(self.seed, pos))

        def producer():
            try:
                for pos, idx in batches:
                    if stop.is_set():
                        break
                    if self.mode == 'process':
                        samples = list(pool.map(
                            _worker_sample,
                            [(self.seed, p, i) for p, i in zip(pos, idx)]))
                    else:
                        samples = list(pool.map(sample_one, zip(pos, idx)))
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
