"""The order nets' and PCNet-M's losses (counterpart of
instaorder_tpu/losses.py: `bce`, `bce_with_logits`, `cross_entropy`,
`cross_entropy_masked`, the label swaps and
`mask_weighted_cross_entropy`).

Every order model in the reference applies its criterion to *already
activated* outputs: nn.CrossEntropyLoss on softmaxed logits and
nn.BCELoss on sigmoided ones (reference models/supervised_order.py). The
CE-on-softmax double normalisation changes the loss surface, so it is
kept: callers pass probabilities, and `cross_entropy` applies
log_softmax to them as torch's criterion would to its input.

The masked variant keeps the reference's `if mask.sum() > 0` guard with
fixed shapes: sum(per_sample * mask) / max(count, 1), and 0 when the
mask is empty. All math is f32.

The disparity losses (`min_max_norm`, `edge_aware_smoothness`,
`disparity_order_violations`) belong to InstaDepthNet training, which
is not ported yet (ROADMAP.md queue 1 item 4).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def bce(probs, targets):
    """torch nn.BCELoss (mean): inputs are probabilities in [0, 1]."""
    p = probs.float()
    t = targets.float()
    logp = torch.clamp(torch.log(p), min=-100.0)
    log1p = torch.clamp(torch.log1p(-p), min=-100.0)
    return -torch.mean(t * logp + (1.0 - t) * log1p)


def bce_with_logits(logits, targets):
    """Fused sigmoid + BCE: the value of bce(sigmoid(logits), targets),
    with the gradient (sigmoid(o) - t) / N, free of the inf * 0 a
    saturated sigmoid gives."""
    o = logits.float()
    t = targets.float()
    # log(sigmoid(o)) = -softplus(-o); log(1 - sigmoid(o)) = -softplus(o)
    return torch.mean(t * F.softplus(-o) + (1.0 - t) * F.softplus(o))


def _picked_nll(inputs, labels):
    """-log_softmax(inputs)[i, labels[i]] per row."""
    logp = torch.log_softmax(inputs.float(), dim=-1)
    return -torch.gather(logp, -1, labels.long()[:, None])[:, 0]


def cross_entropy(inputs, labels):
    """torch nn.CrossEntropyLoss (mean). `inputs` is what the reference
    passes: softmax probabilities (the double-softmax quirk)."""
    return torch.mean(_picked_nll(inputs, labels))


def cross_entropy_masked(inputs, labels, mask):
    """CE over the rows where mask is True; 0 if none are (the
    reference's `if mask.sum() > 0` guard). Labels may hold -1 on
    masked-out rows (clamped before the gather, never read)."""
    m = mask.float()
    count = m.sum()
    picked = _picked_nll(inputs, labels.clamp(min=0))
    loss = (picked * m).sum() / count.clamp(min=1.0)
    return torch.where(count > 0, loss, torch.zeros_like(loss))


def swap_depth_labels(depth_order):
    """Depth label under a mask swap: 0 <-> 1, 2 fixed (reference
    supervised_order.py:40-41, 121-123)."""
    return torch.where(depth_order == 2, depth_order, 1 - depth_order)


def swap_occ_columns(occ_order):
    """(N, 2) occlusion targets under a mask swap: the columns exchanged
    (reference supervised_order.py:48, 516)."""
    return occ_order.flip(-1)


def swap_ordernet_labels(labels):
    """OrderNet 1-of-{3,4} label under a swap: 0 <-> 1, 2 and 3 fixed
    (reference supervised_order.py:459-463)."""
    return torch.where(labels == 0, torch.ones_like(labels),
                       torch.where(labels == 1, torch.zeros_like(labels),
                                   labels))


def mask_weighted_cross_entropy(logits, target, mask, inmask_weight=5.0,
                                outmask_weight=1.0):
    """PCNet-M's per-pixel CE weighted in / out of the eraser (reference
    models/losses.py:60-88): the pixels' CEs (log-softmax in f32) times
    `inmask_weight` where `mask` is set and `outmask_weight` elsewhere,
    summed and divided by N*H*W. logits: (N, H, W, C); target, mask:
    (N, H, W)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    pix = -torch.gather(logp, -1, target.long()[..., None])[..., 0]
    w = torch.where(mask.bool(), torch.full_like(pix, inmask_weight),
                    torch.full_like(pix, outmask_weight))
    n, h, wd = target.shape
    return torch.sum(pix * w) / (n * h * wd)
