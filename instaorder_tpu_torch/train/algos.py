"""Per-algorithm loss semantics (counterpart of
instaorder_tpu/train/algos.py).

Each factory returns `loss_fn(params, stats, batch, train=True) ->
(loss, (new_stats, logs))` with the reference wrapper's training
semantics (models/supervised_order.py):

  * the symmetric double forward with swapped masks, fused by default
    into ONE 2N-batch forward (train-mode BatchNorm then sees the
    statistics of the 2N batch); fused_siamese: False runs the
    reference's two sequential passes, the second starting from the
    running statistics the first returned;
  * the activation-before-criterion quirks (see losses.py);
  * the label permutations under the swap (losses.swap_*).

`net` is a registry entry (models/registry.get_backbone): its
`apply_train` runs the train forward, its `apply` the eval one
(train=False, the eval step). `logs` holds detached tensors on the
batch's device; nothing here syncs with the host.

The options of the hyper dict, as in the JAX package: `use_rgb`,
`fused_siamese`, `compute_dtype` ('bf16': params and inputs cast inside
the autograd graph, so the gradients reach the f32 master params in
f32; BatchNorm statistics in f32) and `remat` (the forward recomputed in
the backward pass, torch.utils.checkpoint without reentrancy).

PartialCompletionMask (PCNet-M) trains the UNet over [modal, eraser]
(+ the RGB patch for the *res variants) against the un-erased mask,
with the eraser-weighted pixel CE. The training of InstaDepthNet_d / _od
(the MiDaS networks: their dorder / smooth losses and the MiDaS weight
ingest) is not ported yet: their factories raise NotImplementedError
(ROADMAP.md queue 1 item 4), and so does `check_ported`, which the
Trainer calls before it builds the net.

Batch convention (NHWC, fixed shapes, tensors on the training device):
  rgb (N,H,W,3) float32 | modal1, modal2 (N,H,W) float32 {0,1}
  occ_order (N,2) float | depth_order (N,) int | is_overlap (N,) int
  count (N,) int | label (N,) int (OrderNet)
  PCNet-M: modal, eraser (N,H,W) float32 | target (N,H,W) int | rgb
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .. import losses as L
from ..core.nn import tree_cast


def _compute_dtype(hyper):
    """The mixed-precision policy of a config ('compute_dtype': 'bf16' |
    'f32'; default full f32, as the reference)."""
    name = hyper.get('compute_dtype', None)
    if name in (None, 'f32', 'float32'):
        return None
    if name in ('bf16', 'bfloat16'):
        return torch.bfloat16
    raise ValueError(f'unknown compute_dtype {name}')


def assemble_pair_input(batch, use_rgb: bool, swap: bool):
    m1 = batch['modal1'][..., None]
    m2 = batch['modal2'][..., None]
    if swap:
        m1, m2 = m2, m1
    parts = [m1, m2] + ([batch['rgb']] if use_rgb else [])
    return torch.cat(parts, dim=-1)


def _double_forward(net, cfg, params, stats, batch, use_rgb, train,
                    fused=True, compute_dtype=None, remat=False):
    """Returns (out1, out2, new_stats); out* may be tuples (dual head)."""
    if compute_dtype is not None:
        params = tree_cast(params, compute_dtype)
        batch = dict(batch)
        for k in ('rgb', 'modal1', 'modal2'):
            if k in batch:
                batch[k] = batch[k].to(compute_dtype)

    def fwd(p, s, x):
        if train:
            return net['apply_train'](p, s, cfg, x)
        return net['apply'](p, s, cfg, x), s

    if remat:
        plain = fwd

        def fwd(p, s, x):
            return checkpoint(plain, p, s, x, use_reentrant=False)

    x1 = assemble_pair_input(batch, use_rgb, swap=False)
    x2 = assemble_pair_input(batch, use_rgb, swap=True)
    if fused:
        out, new_stats = fwd(params, stats, torch.cat([x1, x2], dim=0))
        n = x1.shape[0]
        if isinstance(out, tuple):
            return (tuple(o[:n] for o in out), tuple(o[n:] for o in out),
                    new_stats)
        return out[:n], out[n:], new_stats
    out1, s1 = fwd(params, stats, x1)
    out2, s2 = fwd(params, s1, x2)
    return out1, out2, s2


def _options(hyper, use_rgb_default=False):
    return dict(use_rgb=hyper.get('use_rgb', use_rgb_default),
                fused=hyper.get('fused_siamese', True),
                compute_dtype=_compute_dtype(hyper),
                remat=hyper.get('remat', False))


def _depth_ce(sm1, sm2, batch, ow, dw):
    """The overlap / distinct weighted depth CE of both passes."""
    d1 = batch['depth_order']
    d2 = L.swap_depth_labels(d1)
    ovl = batch['is_overlap'] == 1
    dst = batch['is_overlap'] == 0
    lo = (L.cross_entropy_masked(sm1, d1, ovl) +
          L.cross_entropy_masked(sm2, d2, ovl))
    ld = (L.cross_entropy_masked(sm1, d1, dst) +
          L.cross_entropy_masked(sm2, d2, dst))
    return lo * ow + ld * dw


def _occ_bce(o1, o2, batch):
    """The fused sigmoid + BCE of both passes (value-identical to the
    reference's BCELoss(sigmoid(out)); see losses.bce_with_logits)."""
    occ1 = batch['occ_order']
    return (L.bce_with_logits(o1, occ1) +
            L.bce_with_logits(o2, L.swap_occ_columns(occ1)))


def _detached(logs):
    return {k: v.detach() for k, v in logs.items()}


def make_insta_order_o(net, cfg, hyper):
    """InstaOrderNet_o: 2-sigmoid occlusion + BCE both passes
    (reference supervised_order.py:496-548)."""
    opts = _options(hyper)

    def loss_fn(params, stats, batch, train=True):
        o1, o2, new_stats = _double_forward(net, cfg, params, stats, batch,
                                            train=train, **opts)
        loss = _occ_bce(o1, o2, batch)
        return loss, (new_stats, _detached({'loss': loss}))

    return loss_fn


def make_order_net(net, cfg, hyper):
    """OrderNet / OrderNet_ext: 1-of-{3,4} CE (on softmaxed outputs) with
    the 0<->1 label swap (reference supervised_order.py:442-493)."""
    opts = _options(hyper)

    def loss_fn(params, stats, batch, train=True):
        o1, o2, new_stats = _double_forward(net, cfg, params, stats, batch,
                                            train=train, **opts)
        lab1 = batch['label']
        loss = (L.cross_entropy(torch.softmax(o1, dim=-1), lab1) +
                L.cross_entropy(torch.softmax(o2, dim=-1),
                                L.swap_ordernet_labels(lab1)))
        return loss, (new_stats, _detached({'loss': loss}))

    return loss_fn


def make_insta_order_d(net, cfg, hyper):
    """InstaOrderNet_d: 3-way depth CE (on softmax), overlap / distinct
    weighting (reference supervised_order.py:370-438)."""
    opts = _options(hyper)
    ow = hyper['overlap_weight']
    dw = hyper['distinct_weight']

    def loss_fn(params, stats, batch, train=True):
        o1, o2, new_stats = _double_forward(net, cfg, params, stats, batch,
                                            train=train, **opts)
        loss = _depth_ce(torch.softmax(o1, dim=-1),
                         torch.softmax(o2, dim=-1), batch, ow, dw)
        return loss, (new_stats, _detached({'loss': loss}))

    return loss_fn


def make_insta_order_od(net, cfg, hyper):
    """InstaOrderNet_od: joint 2-sigmoid occ + weighted 3-way depth heads
    (reference supervised_order.py:18-95)."""
    opts = _options(hyper, use_rgb_default=True)
    ow = hyper['overlap_weight']
    dw = hyper['distinct_weight']

    def loss_fn(params, stats, batch, train=True):
        (occ_o1, dep_o1), (occ_o2, dep_o2), new_stats = _double_forward(
            net, cfg, params, stats, batch, train=train, **opts)
        depth_loss = _depth_ce(torch.softmax(dep_o1, dim=-1),
                               torch.softmax(dep_o2, dim=-1), batch, ow, dw)
        occ_loss = _occ_bce(occ_o1, occ_o2, batch)
        loss = depth_loss + occ_loss
        return loss, (new_stats, _detached({
            'loss': loss, 'loss_occ': occ_loss, 'loss_depth': depth_loss}))

    return loss_fn


def make_partial_completion_mask(net, cfg, hyper):
    """PartialCompletionMask (PCNet-M, reference models/partial_completion_
    mask.py:116-126): the UNet over stack(modal, eraser) [+ the RGB
    encoder's input for the *res variants], the mask-weighted pixel CE
    against the un-erased modal."""
    use_rgb = hyper.get('use_rgb', False)
    inmask_weight = hyper.get('inmask_weight', 5.0)

    def loss_fn(params, stats, batch, train=True):
        x = torch.stack([batch['modal'], batch['eraser']], dim=-1)
        kw = {'rgb': batch['rgb']} if use_rgb else {}
        if train:
            logits, new_stats = net['apply_train'](params, stats, cfg, x,
                                                   **kw)
        else:
            logits, new_stats = net['apply'](params, stats, cfg, x,
                                             **kw), stats
        loss = L.mask_weighted_cross_entropy(
            logits, batch['target'], batch['eraser'],
            inmask_weight=inmask_weight, outmask_weight=1.0)
        return loss, (new_stats, _detached({'loss': loss}))

    return loss_fn


NOT_PORTED = ('InstaDepthNet_d', 'InstaDepthNet_od')


def check_ported(algo):
    if algo in NOT_PORTED:
        raise NotImplementedError(
            f"training algo '{algo}' is not ported to instaorder_tpu_torch "
            'yet (ROADMAP.md queue 1 item 4: MiDaS / InstaDepthNet '
            'training)')


def _not_ported(algo):
    def factory(net, cfg, hyper):
        check_ported(algo)
    return factory


ALGOS = {
    'OrderNet': make_order_net,
    'OrderNet_ext': make_order_net,
    'InstaOrderNet_o': make_insta_order_o,
    'InstaOrderNet_d': make_insta_order_d,
    'InstaOrderNet_od': make_insta_order_od,
    'InstaDepthNet_d': _not_ported('InstaDepthNet_d'),
    'InstaDepthNet_od': _not_ported('InstaDepthNet_od'),
    'PartialCompletionMask': make_partial_completion_mask,
}


def make_loss(algo: str, net, cfg, hyper):
    """loss_fn of `algo` over `net` (a registry entry: its `apply` and
    `apply_train`)."""
    if algo not in ALGOS:
        raise KeyError(f"unknown algo '{algo}'; have {sorted(ALGOS)}")
    return ALGOS[algo](net, cfg, hyper)
