"""The data-parallel mesh and process groups (counterpart of
instaorder_tpu/parallel/mesh.py).

The reference's only parallelism is hand-rolled data parallelism over
NCCL (utils/distributed_utils.py:13-37: a parameter broadcast at init and
a gradient all-reduce after backward). The JAX package expresses it as a
1-D `data` mesh that one process drives. Here it is PyTorch's idiom: one
process per device under torch.distributed (NCCL on the cards, gloo on
the CPU), each holding a replica of the parameter trees and its own
1/world slice of every batch, and one flattened all-reduce a step
(parallel/collectives.all_reduce_mean, the counterpart of JAX's single
fused pmean). There is no DistributedDataParallel wrapper: the models
are functional parameter trees.

A mesh is a list of torch devices, one per rank; rank r runs on
mesh[r]. `make_mesh` builds one from the visible cards (or from an
explicit list: `['cpu'] * 8` in the CPU tests, where JAX's tests use 8
virtual CPU devices), `init_data_parallel` joins this process to the
group as one rank, and `init_from_env` joins a torchrun launch. The
predictor (eval/pipeline.OrderPredictor(mesh=...)) uses a mesh in one
process instead: the pair batch split over its devices.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..device import resolve_device

DATA_AXIS = 'data'


def make_mesh(n_devices: int | None = None, devices=None) -> list:
    """A 1-D data-parallel mesh: a list of torch devices. devices None
    is every visible card, as jax.devices() is every local device (no
    card raises); an explicit list is taken as given. Each device goes
    through device.resolve_device (which also pins TF32 off, as every
    entry point does). n_devices keeps the first n and raises when fewer
    are present: a silently truncated mesh would fake multi-device
    coverage."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                'make_mesh: no GPU is available; pass devices= (e.g. '
                "['cpu'] * n) for a mesh on the CPU")
        devices = [torch.device('cuda', i)
                   for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f'requested a {n_devices}-device mesh but only '
                f'{len(devices)} devices are available '
                f'({[str(d) for d in devices]}); a silently truncated '
                f'mesh would fake multi-device coverage')
        devices = devices[:n_devices]
    if not devices:
        raise ValueError('make_mesh: an empty mesh')
    return devices


def init_data_parallel(rank: int, world: int, device, backend=None,
                       init_method: str = 'env://'):
    """Join this process to the data-parallel group as `rank` of `world`,
    running on `device` (through device.resolve_device): backend None
    is NCCL for a CUDA device (made the current device) and gloo for
    the CPU. init_method: 'env://'
    (MASTER_ADDR / MASTER_PORT, as torchrun sets them), a
    'tcp://host:port' address, or a 'file://' store (the tests: parallel
    runs never contend for a port). Returns the default group."""
    import torch.distributed as dist
    device = resolve_device(device)
    if device.type == 'cuda' and device.index is None:
        device = torch.device('cuda', torch.cuda.current_device())
    if backend is None:
        backend = 'nccl' if device.type == 'cuda' else 'gloo'
    if device.type == 'cuda':
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)
    return dist.group.WORLD


def init_from_env(device_type: str = 'cuda'):
    """Join a torchrun launch (the --multihost path): rank and world from
    RANK / WORLD_SIZE, the card from LOCAL_RANK, the rendezvous from
    MASTER_ADDR / MASTER_PORT. Returns (mesh, rank): rank r's device is
    cuda:(r mod LOCAL_WORLD_SIZE), the layout torchrun gives every host,
    or the CPU for device_type 'cpu'."""
    try:
        rank, world = int(os.environ['RANK']), int(os.environ['WORLD_SIZE'])
        local = int(os.environ['LOCAL_RANK'])
    except KeyError as e:
        raise RuntimeError(f'--multihost runs under torchrun (python -m '
                           f'torch.distributed.run); {e} is not set') from e
    if device_type == 'cpu':
        mesh = [torch.device('cpu')] * world
    else:
        per_host = int(os.environ.get('LOCAL_WORLD_SIZE', world))
        mesh = [torch.device('cuda', r % per_host) for r in range(world)]
        if mesh[rank].index != local:
            raise RuntimeError(f'rank {rank}: LOCAL_RANK {local} is not '
                               f'rank mod LOCAL_WORLD_SIZE ({per_host})')
    init_data_parallel(rank, world, mesh[rank])
    return mesh, rank


def data_rank(mesh) -> int:
    """This process's rank in `mesh`: the process group's rank, whose
    world must be the mesh's size; 0 for a 1-device mesh without a
    group."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        if world != len(mesh):
            raise ValueError(f'a {len(mesh)}-device mesh in a process group '
                             f'of world size {world}')
        return dist.get_rank()
    if len(mesh) != 1:
        raise RuntimeError(
            f'a {len(mesh)}-device mesh needs a process group of that '
            f'world size: call parallel.init_data_parallel in each rank')
    return 0


def shard_batch(batch, mesh, rank: int):
    """Rank `rank`'s contiguous 1/len(mesh) slice of axis 0 of every
    field of a batch dict (numpy arrays or tensors, returned as such):
    the rows JAX's shard_batch places on mesh device `rank`. A batch
    axis that does not divide by the mesh size raises, as JAX's
    device_put onto the data sharding does."""
    world = len(mesh)
    if not 0 <= rank < world:
        raise ValueError(f'rank {rank} outside a {world}-device mesh')

    def part(a):
        n = int(a.shape[0])
        if n % world:
            raise ValueError(f'a batch axis of {n} does not divide over a '
                             f'{world}-device mesh')
        k = n // world
        return a[rank * k:(rank + 1) * k]
    return {k: part(v if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in batch.items()}
