"""Collectives over the data-parallel group (counterpart of
instaorder_tpu/parallel/collectives.py, plus the step's all-reduce and
the reference's parameter broadcast).

The gathers keep the JAX package's contracts, which follow the
reference's shape-padded gathers (utils/distributed_utils.py:89-136):
`gather_tensors` -> one numpy array per rank, `gather_tensors_batch` ->
their concatenation, `process_allgather` -> the identity in one process.
`all_reduce_mean` is the train step's single fused pmean: every tensor
leaf of a tree in one flat bucket, summed, divided by the world size and
written back into the leaves' shapes. `broadcast_tree` is the
reference's broadcast_params (distributed_utils.py:13-21).

Without an initialized process group every function acts as at a world
size of 1. Gloo's CUDA support covers all_reduce and broadcast; the
gathers move a CUDA tensor to the host first under gloo, and NCCL runs
everything on the current card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.nn import tree_leaves, tree_unflatten


def _initialized() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def _gather_device(group):
    """Where a gather runs: the current card under NCCL, the host under
    gloo (whose CUDA support stops at all_reduce and broadcast)."""
    import torch.distributed as dist
    if dist.get_backend(group) == 'nccl':
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device('cpu')


def all_reduce_mean(tree, group=None):
    """The mean over the group of every tensor leaf of `tree` (a nested
    dict / list / tuple: the gradients, new statistics and logs of a
    step together), as a new tree of the same structure (tuples come
    back as lists), each leaf in its own dtype and on its own device.
    One collective: the leaves flattened into one bucket (f32, f64 if a
    leaf is f64), summed, divided by the world size. Nothing waits on
    the host. Without a process group the tree is returned as it is."""
    import torch.distributed as dist
    if not _initialized():
        return tree
    leaves = tree_leaves(tree)
    dt = torch.float64 if any(t.dtype == torch.float64 for t in leaves) \
        else torch.float32
    # few host ops a leaf (the step's tree has hundreds): no autograd, a
    # cast only where a leaf's dtype is not the bucket's, and the leaves
    # given back as views of the bucket where it is
    with torch.no_grad():
        flat = torch.cat([t.reshape(-1) if t.dtype == dt
                          else t.reshape(-1).to(dt) for t in leaves])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        flat.div_(dist.get_world_size(group))
        parts = torch.split(flat, [t.numel() for t in leaves])
        return tree_unflatten(tree, [
            p.view(t.shape) if t.dtype == dt else p.view(t.shape).to(t.dtype)
            for p, t in zip(parts, leaves)])


def broadcast_tree(tree, src: int = 0, group=None):
    """Every tensor leaf of `tree` as rank `src` holds it (one broadcast
    for each leaf dtype), as a new tree; the tree itself without a
    process group."""
    import torch.distributed as dist
    if not _initialized():
        return tree
    leaves = tree_leaves(tree)
    out = list(leaves)
    for dt in dict.fromkeys(t.dtype for t in leaves):
        idx = [i for i, t in enumerate(leaves) if t.dtype == dt]
        flat = torch.cat([leaves[i].detach().reshape(-1) for i in idx])
        dist.broadcast(flat, src=src, group=group)
        for i, p in zip(idx, flat.split([leaves[i].numel() for i in idx])):
            out[i] = p.view(leaves[i].shape)
    return tree_unflatten(tree, out)


def all_gather_cat(t, group=None):
    """Every rank's tensor `t` (one shape on every rank) concatenated on
    axis 0 in rank order, on t's device (under gloo through the host);
    `t` itself without a process group."""
    import torch.distributed as dist
    if not _initialized():
        return t
    x = t.detach().contiguous().to(_gather_device(group))
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts).to(t.device)


def gather_tensors(array, group=None):
    """Every rank's `array` (a numpy array or tensor; the shapes may
    differ in every axis, the rank may not) -> a list of numpy arrays in
    rank order: padded to the largest shape, all-gathered, cropped, as
    the reference's gather_tensors. In one process, [the array]."""
    import torch.distributed as dist
    if not _initialized():
        return [array.detach().cpu().numpy()
                if isinstance(array, torch.Tensor) else np.asarray(array)]
    dev = _gather_device(group)
    x = array.detach() if isinstance(array, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(array))
    x = x.to(dev)
    world = dist.get_world_size(group)
    shape = torch.tensor(x.shape, dtype=torch.int64, device=dev)
    shapes = [torch.empty_like(shape) for _ in range(world)]
    dist.all_gather(shapes, shape, group=group)
    top = torch.stack(shapes).amax(0).tolist()
    padded = x.new_zeros(top)
    padded[tuple(slice(0, n) for n in x.shape)] = x
    parts = [torch.empty_like(padded) for _ in range(world)]
    dist.all_gather(parts, padded, group=group)
    return [p[tuple(slice(0, n) for n in s.tolist())].cpu().numpy()
            for p, s in zip(parts, shapes)]


def gather_tensors_batch(array, part_size=None, group=None):
    """The ranks' arrays concatenated on axis 0 (the reference's
    gather_tensors_batch; part_size, its chunking of the all-gather to
    bound memory, is accepted and not needed)."""
    return np.concatenate(gather_tensors(array, group), axis=0)


def process_allgather(x, group=None):
    """Every process's `x` stacked on a new leading axis (same shape on
    every rank), as jax.experimental.multihost_utils.process_allgather;
    in one process the array itself."""
    import torch.distributed as dist
    if not _initialized() or dist.get_world_size(group) == 1:
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x)
    return np.stack(gather_tensors(x, group))
