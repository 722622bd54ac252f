"""Train and eval steps (counterpart of instaorder_tpu/train/step.py).

The reference's hot loop is: forward x2 -> loss/world_size -> backward
-> per-parameter NCCL all_reduce -> SGD step (trainer.py:158-216 +
supervised_order.py:535-548 + distributed_utils.py:27-31). A train step
here is the same: the loss and its gradients by autograd on this
replica's batch (per-replica BatchNorm, as the reference's unsynced BN
and JAX's shard_map), then with a mesh one all-reduce of the gradients,
the new BatchNorm statistics and the logs together
(parallel/collectives.all_reduce_mean: the mean over the ranks, JAX's
single fused pmean), then the optimizer's update on every rank. The
loss stays the undivided local mean and the gradients are averaged,
which is the reference's divide-then-sum (instaorder_tpu/train/
algos.py:15-18). Without a mesh, or at a world size of 1 without a
process group, the step is the one-device step and no collective runs.

The LR arrives as a Python float from the host schedule (reference
trainer.py:161). The logs come back as detached tensors on the device:
nothing in a step reads a value to the host, so the host can queue the
next step while this one runs (NCCL's all-reduce is queued on the
stream as a kernel is; gloo's, on CUDA tensors, copies through the host
and so waits for the backward); the Trainer reads the logs at
print_freq.
"""

from __future__ import annotations

import torch

from ..core.nn import tree_leaves, tree_unflatten
from ..parallel.collectives import all_gather_cat, all_reduce_mean
from ..parallel.mesh import data_rank, shard_batch


def build_train_step(loss_fn, optimizer, mesh=None):
    """Returns `step(params, stats, opt_state, batch, lr) -> (params,
    stats, opt_state, logs)`: new trees, the inputs left as they were.
    mesh: the data-parallel mesh (parallel/mesh.make_mesh) whose process
    group this rank belongs to; `batch` is then this rank's shard."""
    if mesh is not None:
        data_rank(mesh)

    def step(params, stats, opt_state, batch, lr):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        loss, (new_stats, logs) = loss_fn(tree_unflatten(params, leaves),
                                          stats, batch, train=True)
        # a leaf the loss does not reach (InstaDepthNet_od's occlusion
        # branch at occ_order_weight 0) gets a zero gradient, as under
        # jax.grad, so that weight decay still moves it
        grads = [torch.zeros_like(x) if g is None else g for x, g in zip(
            leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]
        if mesh is not None:
            grads, new_stats, logs = all_reduce_mean(
                (grads, new_stats, logs))
        new_params, new_opt = optimizer.update(
            tree_unflatten(params, grads), opt_state, params, lr)
        return new_params, new_stats, new_opt, logs

    return step


def build_eval_step(loss_fn, mesh=None):
    """The forward-only loss logs with eval-mode BatchNorm, no autograd
    (reference Trainer.validate, trainer.py:218-266); with a mesh, on
    this rank's shard, the logs averaged over the ranks."""
    if mesh is not None:
        data_rank(mesh)

    @torch.no_grad()
    def step(params, stats, batch):
        _, (_, logs) = loss_fn(params, stats, batch, train=False)
        return logs if mesh is None else all_reduce_mean(logs)

    return step


def build_forward(net, cfg, mesh=None, train=False):
    """A plain forward without autograd: `net['apply']` (eval), or the
    output of `net['apply_train']` (train-mode BatchNorm). With a mesh
    (its process group joined), each rank runs its shard of the batch
    (parallel/mesh.shard_batch; train-mode statistics per replica, as
    JAX's shard_map) and every rank gets the whole output, the shards'
    rows gathered in rank order, as JAX's data-sharded output."""
    rank = None if mesh is None else data_rank(mesh)

    def run(params, stats, x):
        if train:
            return net['apply_train'](params, stats, cfg, x)[0]
        return net['apply'](params, stats, cfg, x)

    @torch.no_grad()
    def fwd(params, stats, x):
        if rank is None:
            return run(params, stats, x)
        out = run(params, stats, shard_batch({'x': x}, mesh, rank)['x'])
        if isinstance(out, tuple):
            return tuple(all_gather_cat(o) for o in out)
        return all_gather_cat(out)

    return fwd
