"""The plain reference of InstaOrderNet^od's training step, data-parallel.

The InstaOrder reference (models/supervised_order.py, trainer.py): both
mask orders of every pair in one forward of the 2N batch (train-mode
BatchNorm over that batch, each rank on its own), the occlusion BCE on
the sigmoid of the logits, the depth cross-entropy taken over the
softmax of the depth logits (the reference's softmax-then-CrossEntropy),
weighted by overlap / distinct pairs; the gradients averaged over the
ranks; torch's SGD with momentum 0.9 and weight decay:
    g <- g + wd p ; buf <- 0.9 buf + g ; p <- p - lr buf.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import model


def _ce(probs, labels, mask):
    """CrossEntropy over the rows in `mask` of `probs` taken as logits;
    0 where no row is."""
    logp = torch.log_softmax(probs, dim=-1)
    nll = -logp.gather(-1, labels.clamp(min=0).long()[:, None])[:, 0]
    m = mask.float()
    n = m.sum()
    return torch.where(n > 0, (nll * m).sum() / n.clamp(min=1.0),
                       torch.zeros_like(n))


def _bce(logits, target):
    return torch.mean(target * F.softplus(-logits)
                      + (1.0 - target) * F.softplus(logits))


def loss_od(params, batch, overlap_weight, distinct_weight):
    """InstaOrderNet^od's loss on one rank's batch: rgb (N, H, W, 3),
    modal1 / modal2 (N, H, W), occ_order (N, 2), depth_order (N,),
    is_overlap (N,)."""
    m1, m2 = batch['modal1'][..., None], batch['modal2'][..., None]
    x1 = torch.cat([m1, m2, batch['rgb']], dim=-1)
    x2 = torch.cat([m2, m1, batch['rgb']], dim=-1)
    occ, dep = model.forward_train(params, torch.cat([x1, x2]))
    n = x1.shape[0]
    d1 = batch['depth_order']
    d2 = torch.where(d1 == 2, d1, 1 - d1)
    ovl, dst = batch['is_overlap'] == 1, batch['is_overlap'] == 0
    s1, s2 = torch.softmax(dep[:n], -1), torch.softmax(dep[n:], -1)
    depth = ((_ce(s1, d1, ovl) + _ce(s2, d2, ovl)) * overlap_weight
             + (_ce(s1, d1, dst) + _ce(s2, d2, dst)) * distinct_weight)
    t = batch['occ_order'].float()
    return depth + _bce(occ[:n], t) + _bce(occ[n:], t.flip(-1))


def leaves(tree):
    """The tensor leaves of a nested dict / list tree, in key order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [rebuild(v, it) for v in tree]
    return next(it)


def grads_mean(params, rank_batches, hyper, fault=None):
    """(mean loss, mean gradient leaves) over the ranks' batches, each
    rank's loss and gradient on its own batch. fault (the checks' planted
    faults): 'half' takes each rank's loss over the first half of its
    rows; 'no_exchange' keeps rank 0's gradient alone."""
    grads, losses = None, []
    for r, batch in enumerate(rank_batches):
        if fault == 'half':
            k = batch['rgb'].shape[0] // 2
            batch = {key: v[:k] for key, v in batch.items()}
        ls = [p.detach().requires_grad_(True) for p in leaves(params)]
        loss = loss_od(rebuild(params, iter(ls)), batch,
                       hyper['overlap_weight'], hyper['distinct_weight'])
        g = torch.autograd.grad(loss, ls)
        losses.append(loss.detach())
        if fault == 'no_exchange' and r > 0:
            continue
        grads = list(g) if grads is None else [a + b for a, b in zip(grads, g)]
    k = 1 if fault == 'no_exchange' else len(rank_batches)
    return torch.stack(losses).mean(), [g / k for g in grads]


def sgd(p, g, buf, lr, wd, momentum=0.9):
    """torch.optim.SGD's update of leaf lists: (new params, new buffers)."""
    gs = [gi + wd * pi for gi, pi in zip(g, p)]
    bufs = [gi if b is None else momentum * b + gi for b, gi in zip(buf, gs)]
    return [pi - lr * b for pi, b in zip(p, bufs)], bufs
