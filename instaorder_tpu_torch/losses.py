"""The order nets' and PCNet-M's losses (counterpart of
instaorder_tpu/losses.py: `bce`, `bce_with_logits`, `cross_entropy`,
`cross_entropy_masked`, the label swaps, InstaDepthNet's `min_max_norm`,
`edge_aware_smoothness` and `disparity_order_violations`,
`mask_weighted_cross_entropy`, and the deocclusion terms of the legacy
nets (models/legacy.py): `l2_with_ignore`, `adversarial_loss`,
`gram_matrix`, `total_variation_loss`, `inpainting_loss`).

Every order model in the reference applies its criterion to *already
activated* outputs: nn.CrossEntropyLoss on softmaxed logits and
nn.BCELoss on sigmoided ones (reference models/supervised_order.py). The
CE-on-softmax double normalisation changes the loss surface, so it is
kept: callers pass probabilities, and `cross_entropy` applies
log_softmax to them as torch's criterion would to its input.

The masked variant keeps the reference's `if mask.sum() > 0` guard with
fixed shapes: sum(per_sample * mask) / max(count, 1), and 0 when the
mask is empty. All math is f32.

The disparity terms follow JAX's derivatives, which differ from
PyTorch's in two places: |x| has derivative +1 at x = 0 (and at -0) in
JAX and 0 in `torch.abs`, so `_abs` writes it as JAX's select; and the
reductions are `amin` / `amax`, which split the gradient evenly among
tied extrema as `jnp.min` / `jnp.max` do (`torch.max(dim=...)` sends it
to one index). A ReLU'd disparity holds runs of exact zeros, so both
cases are common, not rare. The inpainting L1 terms take |x| the same
way: their masked differences are exact zeros wherever the mask cuts.
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


def _abs(x):
    """|x| with JAX's derivative: sign +1 where x >= 0 (0 and -0
    included), -1 elsewhere."""
    return torch.where(x >= 0, x, -x)


def min_max_norm(disp, eps=1e-7):
    """Per-image min-max normalisation of (N, H, W) disparity
    (reference supervised_order.py:212-215; the denominator is max + eps,
    not max - min, kept for parity)."""
    mn = torch.amin(disp, dim=(-2, -1), keepdim=True)
    mx = torch.amax(disp, dim=(-2, -1), keepdim=True)
    return (disp - mn) / (mx + eps)


def edge_aware_smoothness(disp, rgb, eps=1e-7):
    """Edge-aware disparity smoothness (reference supervised_order.py:
    217-237). disp: (N, H, W); rgb: (N, H, W, 3), the normalised image."""
    d = min_max_norm(disp, eps)
    d = d / (torch.mean(d, dim=(-2, -1), keepdim=True) + eps)
    gx = _abs(d[..., :, :-1] - d[..., :, 1:])
    gy = _abs(d[..., :-1, :] - d[..., 1:, :])
    igx = torch.mean(torch.abs(rgb[..., :, :-1, :] - rgb[..., :, 1:, :]),
                     dim=-1)
    igy = torch.mean(torch.abs(rgb[..., :-1, :, :] - rgb[..., 1:, :, :]),
                     dim=-1)
    return (torch.mean(gx * torch.exp(-igx)) +
            torch.mean(gy * torch.exp(-igy)))


def disparity_order_violations(disp1, disp2, m1_eroded, m2_eroded,
                               depth_order, distinct_mask):
    """InstaDepthNet's disparity-order violation count (reference
    supervised_order.py:157-179), on the device.

    For each distinct (non-overlapping) pair of order 0 (1 nearer than
    2): the pixels of eroded mask 1 whose disp1 does not exceed max(disp1
    over eroded mask 2), the pixels of mask 2 not below min(disp1 over
    mask 1), and the two mirrored terms on the swapped pass's disp2;
    order 1 reverses the inequalities. The comparisons carry no gradient
    (bool tensors in the reference too): the count is taken on detached
    f32 values and returned as an f32 scalar without a graph.

    disp*: (N, H, W); m*_eroded: (N, H, W) bool; depth_order: (N,) int;
    distinct_mask: (N,) bool."""
    m1 = m1_eroded.bool()
    m2 = m2_eroded.bool()
    big = torch.tensor(-3.4e38, dtype=torch.float32, device=disp1.device)
    small = torch.tensor(3.4e38, dtype=torch.float32, device=disp1.device)

    def counts(d, flip):
        d = d.detach().float()
        max2 = torch.amax(torch.where(m2, d, big), dim=(-2, -1))[:, None,
                                                                  None]
        min1 = torch.amin(torch.where(m1, d, small), dim=(-2, -1))[:, None,
                                                                   None]
        if not flip:    # order 0 on pass 1: want d[m1] > max(d[m2])
            c1 = ((d <= max2) & m1).sum(dim=(-2, -1))
            c2 = ((min1 <= d) & m2).sum(dim=(-2, -1))
        else:
            c1 = ((d >= max2) & m1).sum(dim=(-2, -1))
            c2 = ((min1 >= d) & m2).sum(dim=(-2, -1))
        return (c1 + c2).float()

    per0 = counts(disp1, False) + counts(disp2, True)   # depth_order 0
    per1 = counts(disp1, True) + counts(disp2, False)   # depth_order 1
    zero = torch.zeros_like(per0)
    per = torch.where(depth_order == 0, per0,
                      torch.where(depth_order == 1, per1, zero))
    return torch.where(distinct_mask.bool(), per, zero).sum()


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


def l2_with_ignore(pred, target, ignore_value=None):
    """Mean squared error, over the pixels whose target is not
    `ignore_value` when one is given (reference models/losses.py:45-57)."""
    t = target.float()
    if ignore_value is None:
        return torch.mean((pred - t) ** 2)
    m = (target != ignore_value).float()
    return torch.sum((pred - t) ** 2 * m) / torch.clamp(torch.sum(m),
                                                        min=1.0)


def adversarial_loss(outputs, is_real, is_disc=None, loss_type='nsgan',
                     real_label=1.0, fake_label=0.0):
    """GAN loss (reference models/losses.py:5-42): nsgan (BCE on sigmoid
    outputs), lsgan (MSE), hinge."""
    o = outputs.float()
    if loss_type == 'hinge':
        if is_disc:
            o = -o if is_real else o
            return torch.mean(torch.relu(1.0 + o))
        return torch.mean(-o)
    label = torch.full_like(o, real_label if is_real else fake_label)
    if loss_type == 'nsgan':
        return bce(o, label)
    if loss_type == 'lsgan':
        return torch.mean((o - label) ** 2)
    raise ValueError(loss_type)


def gram_matrix(feat):
    """(N, H, W, C) -> (N, C, C) Gram matrix over C * H * W
    (losses.py:91-97)."""
    n, h, w, c = feat.shape
    f = feat.reshape(n, h * w, c)
    return torch.einsum('nxc,nxd->ncd', f, f) / (c * h * w)


def _l1(a, b):
    return torch.mean(_abs(a - b))


def total_variation_loss(image):
    """(N, H, W, C) mean |one-pixel shift| along W plus along H
    (losses.py:100-104)."""
    return (_l1(image[:, :, :-1], image[:, :, 1:]) +
            _l1(image[:, :-1], image[:, 1:]))


def inpainting_loss(inp, mask, output, gt, extractor=None):
    """The hole / valid / perceptual / style / tv terms of the partial-
    convolution inpainting loss (losses.py:107-145), NHWC. extractor(img)
    -> [feat1, feat2, feat3] (the VGG16 slices, models/legacy); without
    one the perceptual ('prc') and style terms are left out. A 1-channel
    image is tiled to 3 channels for the extractor. Returns {term:
    scalar}."""
    comp = mask * inp + (1 - mask) * output
    out = {'hole': _l1((1 - mask) * output, (1 - mask) * gt),
           'valid': _l1(mask * output, mask * gt)}
    if extractor is not None:
        def to3(t):
            return t if t.shape[-1] == 3 else t.repeat(1, 1, 1, 3)
        f_comp = extractor(to3(comp))
        f_out = extractor(to3(output))
        f_gt = extractor(to3(gt))
        out['prc'] = sum(_l1(a, g) + _l1(c, g) for a, c, g in
                         zip(f_out, f_comp, f_gt))
        out['style'] = sum(
            _l1(gram_matrix(a), gram_matrix(g)) +
            _l1(gram_matrix(c), gram_matrix(g))
            for a, c, g in zip(f_out, f_comp, f_gt))
    out['tv'] = total_variation_loss(comp)
    return out
