"""Train and eval steps on one device (counterpart of
instaorder_tpu/train/step.py at a world size of 1).

The reference's hot loop is: forward x2 -> loss -> backward -> SGD step
(trainer.py:158-216 + supervised_order.py:535-548). A train step here is
the same: the loss and its gradients by autograd, the optimizer's
update, and the new BatchNorm statistics. It is the JAX package's step
on a 1-device mesh, where the pmean of the gradients, statistics and
logs is the identity. Data-parallel training across cards (per-replica
BatchNorm, a gradient all-reduce) is the `parallel/` slice, not ported
yet (ROADMAP.md).

The LR arrives as a Python float from the host schedule (reference
trainer.py:161). The logs come back as detached tensors on the device:
nothing in a step waits for the device, so the host can queue the next
step while this one runs; the Trainer reads the logs at print_freq.
"""

from __future__ import annotations

import torch

from ..core.nn import tree_leaves, tree_unflatten


def build_train_step(loss_fn, optimizer):
    """Returns `step(params, stats, opt_state, batch, lr) -> (params,
    stats, opt_state, logs)`: new trees, the inputs left as they were."""

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
        new_params, new_opt = optimizer.update(
            tree_unflatten(params, grads), opt_state, params, lr)
        return new_params, new_stats, new_opt, logs

    return step


def build_eval_step(loss_fn):
    """The forward-only loss logs with eval-mode BatchNorm, no autograd
    (reference Trainer.validate, trainer.py:218-266)."""

    @torch.no_grad()
    def step(params, stats, batch):
        _, (_, logs) = loss_fn(params, stats, batch, train=False)
        return logs

    return step


def build_forward(net, cfg, train=False):
    """A plain forward without autograd: `net['apply']` (eval), or the
    output of `net['apply_train']` (train-mode BatchNorm)."""

    @torch.no_grad()
    def fwd(params, stats, x):
        if train:
            return net['apply_train'](params, stats, cfg, x)[0]
        return net['apply'](params, stats, cfg, x)

    return fwd
