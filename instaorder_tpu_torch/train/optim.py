"""Optimizers with torch's update rules, written out over the port's
parameter trees (counterpart of instaorder_tpu/train/optim.py).

The reference trains with torch.optim.SGD(momentum=0.9, weight_decay)
or Adam(beta1, 0.999) (models/single_stage_model.py:35-44). They are
written out here, not taken from `torch.optim`, so that the optimizer
state has the JAX package's tree, {'buf': params-like} and {'m', 'v',
't'} (t an int32 scalar), and a checkpoint's `opt_state` reads in both
packages. The LR is an argument of `update`, as the reference mutates
param_group['lr'] every iteration (utils/scheduler.py:28-33).

`update(grads, state, params, lr) -> (new_params, new_state)` is
functional, as in the JAX package: new tensors, nothing written in
place, no autograd graph (it runs under torch.no_grad()), and no sync
with the host (Adam's bias corrections stay on the device).

torch SGD (nesterov=False):
    g <- g + wd * p
    buf <- momentum * buf + g        (buf starts as g: zeros init matches)
    p <- p - lr * buf
torch Adam:
    m <- b1 m + (1-b1) g ; v <- b2 v + (1-b2) g^2
    p <- p - lr * (m / (1-b1^t)) / (sqrt(v / (1-b2^t)) + eps)
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.nn import tree_leaves, tree_map, tree_unflatten


class SGD(NamedTuple):
    momentum: float = 0.9
    weight_decay: float = 0.0

    def init(self, params):
        return {'buf': tree_map(torch.zeros_like, params)}

    @torch.no_grad()
    def update(self, grads, state, params, lr):
        p = tree_leaves(params)
        g = tree_leaves(grads)
        if self.weight_decay:
            g = torch._foreach_add(g, p, alpha=self.weight_decay)
        buf = torch._foreach_mul(tree_leaves(state['buf']), self.momentum)
        torch._foreach_add_(buf, g)
        step = torch._foreach_mul(buf, lr)
        new = torch._foreach_sub(p, step)
        return (tree_unflatten(params, new),
                {'buf': tree_unflatten(params, buf)})


class Adam(NamedTuple):
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0

    def init(self, params):
        leaf = tree_leaves(params)[0]
        return {'m': tree_map(torch.zeros_like, params),
                'v': tree_map(torch.zeros_like, params),
                't': torch.zeros((), dtype=torch.int32, device=leaf.device)}

    @torch.no_grad()
    def update(self, grads, state, params, lr):
        b1, b2 = self.b1, self.b2
        wd = self.weight_decay
        t = state['t'] + 1
        c1 = 1 - b1 ** t.float()
        c2 = 1 - b2 ** t.float()

        def leaf(p, g, m, v):
            if wd:
                g = g + wd * p
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            return p - lr * (m / c1) / (torch.sqrt(v / c2) + self.eps), m, v

        out = tree_map(leaf, params, grads, state['m'], state['v'])
        return _pick(out, 0), {'m': _pick(out, 1), 'v': _pick(out, 2),
                               't': t}


def _pick(tree, i):
    """The i-th element of every (tuple) leaf of a tree of tuples."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pick(v, i) for v in tree]
    return tree[i]


def make_optimizer(name: str, lr_unused=None, weight_decay=0.0, beta1=0.9):
    """Config-string dispatch matching single_stage_model.py:35-44."""
    if name == 'SGD':
        return SGD(momentum=0.9, weight_decay=weight_decay)
    if name == 'Adam':
        return Adam(b1=beta1, b2=0.999)
    raise ValueError(f"No such optimizer: {name}")
