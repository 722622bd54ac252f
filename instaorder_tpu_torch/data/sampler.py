"""Deterministic iteration-budget samplers (counterpart of
instaorder_tpu/data/sampler.py: the same index streams).

The reference's seed-0 streams (utils/distributed_utils.py:139-254): the
item indices tiled to the iteration budget and shuffled with seed 0, a
contiguous slice per rank, and `last_iter` skipped on resume. The
reference and the JAX package seed numpy's global generator for the
shuffle; here a RandomState(0) of its own draws the same permutation and
leaves the global generator alone.
"""

from __future__ import annotations

import math

import numpy as np


def _tiled_shuffled(n_items: int, all_size: int) -> np.ndarray:
    indices = np.arange(n_items)[:all_size]
    num_repeat = (all_size - 1) // indices.shape[0] + 1
    indices = np.tile(indices, num_repeat)[:all_size]
    np.random.RandomState(0).shuffle(indices)
    return indices


class GivenIterationSampler:
    def __init__(self, n_items, total_iter, batch_size, last_iter=-1):
        self.total_size = total_iter * batch_size
        self.batch_size = batch_size
        self.last_iter = last_iter
        self.indices = _tiled_shuffled(n_items, self.total_size)

    def __iter__(self):
        return iter(self.indices[(self.last_iter + 1) * self.batch_size:])

    def __len__(self):
        return self.total_size


class DistributedGivenIterationSampler:
    def __init__(self, n_items, total_iter, batch_size, world_size, rank,
                 last_iter=-1):
        if not 0 <= rank < world_size:
            raise ValueError(f'rank {rank} outside world size {world_size}')
        self.total_size = total_iter * batch_size
        self.batch_size = batch_size
        self.last_iter = last_iter
        indices = _tiled_shuffled(n_items, self.total_size * world_size)
        beg = self.total_size * rank
        self.indices = indices[beg:beg + self.total_size]

    def __iter__(self):
        return iter(self.indices[(self.last_iter + 1) * self.batch_size:])

    def __len__(self):
        return self.total_size


class DistributedSequentialSampler:
    """Contiguous per-rank val shards padded (by wrapping) to equal size."""

    def __init__(self, n_items, world_size, rank):
        if n_items < world_size:
            raise ValueError(f'{n_items} items for {world_size} ranks')
        sub_num = int(math.ceil(n_items / world_size))
        self.beg = sub_num * rank
        self.end = self.beg + sub_num
        self.padded = list(range(n_items)) + list(
            range(sub_num * world_size - n_items))

    def __iter__(self):
        return iter(self.padded[self.beg:self.end])

    def __len__(self):
        return self.end - self.beg
