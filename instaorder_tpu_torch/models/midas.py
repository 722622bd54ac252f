"""MiDaS v2.1 monocular disparity and the InstaDepthNet order heads, NHWC
(counterpart of instaorder_tpu/models/midas.py: `init`, `apply` and their
blocks; the eval forward is `apply`, JAX's train=True is `apply_train`,
as in the port's `resnet`).

Reference:
  MidasNet            <- midas/midas_net.py:215-277
  InstaDepthNet_d     <- midas/midas_net.py:15-113
  InstaDepthNet_od    <- midas/midas_net.py:116-212
  blocks (scratch reprojections, ResidualConvUnit, FeatureFusionBlock,
  output conv stack)  <- midas/blocks.py:19-195

A ResNeXt-101 32x8d trunk (grouped 3x3 convolutions, groups 32) feeds
four unbiased 3x3 `scratch` reprojections to `features` channels, then a
top-down chain of fusion blocks (residual conv units, then a x2 bilinear
upsample with align_corners=True) and the disparity head (conv, x2
upsample with align_corners=False, conv, relu, 1x1, relu). The
InstaDepthNet order branches are headless ResNet-50s over cat(mask1,
mask2) whose stages 2-4 take the trunk's layer1..3 features added to
their input. Every convolution is cuDNN f32 on the card (TF32 off,
`device.resolve_device`) but the head's first (`_conv_without_cudnn`);
the resizes are two f32 matmuls each.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..convert import tree_to
from ..core import nn as cnn
from ..ops.resize import resize, upsample_bilinear_align_corners
from . import resnet

VARIANTS = ('midas', 'instadepthnet_d', 'instadepthnet_od')
TRUNK_DIMS = (256, 512, 1024, 2048)


def _upsample2x_half_pixel(x):
    """torch F.interpolate(scale_factor=2, bilinear, align_corners=False)
    (cv2 INTER_LINEAR's index map) of NHWC x."""
    h, w = x.shape[1], x.shape[2]
    return resize(x.permute(0, 3, 1, 2), 2 * h, 2 * w,
                  'linear').permute(0, 2, 3, 1)


def _upsample2x_align(x):
    """torch F.interpolate(scale_factor=2, bilinear, align_corners=True)
    of NHWC x: the fusion blocks' upsample."""
    h, w = x.shape[1], x.shape[2]
    return upsample_bilinear_align_corners(x.permute(0, 3, 1, 2), 2 * h,
                                           2 * w).permute(0, 2, 3, 1)


def _rcu_init(gen, features):
    return {'conv1': cnn.conv_init(gen, 3, 3, features, features, bias=True),
            'conv2': cnn.conv_init(gen, 3, 3, features, features, bias=True)}


def _rcu_apply(p, x):
    """Residual conv unit: relu, conv, relu, conv, plus x."""
    out = cnn.conv2d(p['conv1'], torch.relu(x), padding=1)
    out = cnn.conv2d(p['conv2'], torch.relu(out), padding=1)
    return out + x


def _fusion_init(gen, features):
    return {'rcu1': _rcu_init(gen, features), 'rcu2': _rcu_init(gen, features)}


def _fusion_apply(p, x, skip=None):
    """Feature fusion block: x (+ rcu1(skip)), rcu2, x2 align-corners
    upsample."""
    out = x
    if skip is not None:
        out = out + _rcu_apply(p['rcu1'], skip)
    return _upsample2x_align(_rcu_apply(p['rcu2'], out))


def _conv_without_cudnn(p, x):
    """The head's first 3x3 conv (features -> 128), padding 1, outside
    cuDNN. For it cuDNN's f32 heuristic (TF32 off) picks an FFT algorithm
    at square maps (batch 1: 160^2-224^2, batch 12: 96^2-224^2; the 384^2
    inputs of InstaOrder, DIW and NYU give 192^2), which runs ~250 ms
    where PyTorch's own im2col + cuBLAS route (TF32 off as well) takes
    ~1 ms, and takes 16-19 GiB of workspace. Same f32 math, another
    summation order (~1e-6 of max |cuDNN|; PERF.md §6, the MiDaS
    findings; chip_smoke.py phase 7 times both routes)."""
    with torch.backends.cudnn.flags(enabled=False, allow_tf32=False):
        return cnn.conv2d(p, x, padding=1)


def init(gen, features=256, depth_num_classes=3, occ_num_classes=2,
         variant='midas', non_negative=True, trunk_layers=None,
         branch_layers=None, device='cpu'):
    """(params, stats, cfg) with the JAX package's keys and shapes.
    variant: 'midas' | 'instadepthnet_d' | 'instadepthnet_od';
    trunk_layers / branch_layers: per-stage block counts (tests). gen: a
    torch.Generator on the CPU; the tree is drawn there and moved to
    `device`."""
    if variant not in VARIANTS:
        raise ValueError(f'variant must be one of {VARIANTS}, got {variant!r}')
    p: Dict[str, Any] = {}
    s: Dict[str, Any] = {}
    p['trunk'], s['trunk'], tcfg = resnet.init(
        gen, arch='resnext101_32x8d', in_channels=3, with_head=False,
        layers_override=trunk_layers)
    for i, cin in enumerate(TRUNK_DIMS, 1):
        p[f'scratch{i}'] = cnn.conv_init(gen, 3, 3, cin, features)
    for i in range(1, 5):
        p[f'refinenet{i}'] = _fusion_init(gen, features)
    p['out_conv1'] = cnn.conv_init(gen, 3, 3, features, 128, bias=True)
    p['out_conv2'] = cnn.conv_init(gen, 3, 3, 128, 32, bias=True)
    p['out_conv3'] = cnn.conv_init(gen, 1, 1, 32, 1, bias=True)
    cfg = {'variant': variant, 'features': features, 'trunk_cfg': tcfg,
           'non_negative': non_negative}

    def order_branch(n_classes):
        bp, bs, bcfg = resnet.init(gen, arch='resnet50', in_channels=2,
                                   weight_init='xavier', with_head=False,
                                   layers_override=branch_layers)
        # the reference's separate fc keeps torch's default init (it is
        # outside the xavier init_weights call, midas_net.py:51-52)
        head = cnn.linear_init(gen, 2048, n_classes, init='torch_default')
        return {'net': bp, 'fc': head}, {'net': bs}, bcfg

    if variant == 'instadepthnet_d':
        p['gdo'], s['gdo'], cfg['gdo_cfg'] = order_branch(depth_num_classes)
    elif variant == 'instadepthnet_od':
        p['do'], s['do'], cfg['do_cfg'] = order_branch(depth_num_classes)
        p['oo'], s['oo'], cfg['oo_cfg'] = order_branch(occ_num_classes)
    return tree_to(p, device), tree_to(s, device), cfg


def _disp_path(params, stats, cfg, img, train=False):
    """(disp (N, H, W), the trunk's feature dict, the trunk's new
    statistics (train) or None) of NHWC img."""
    if train:
        feats, trunk_stats = resnet.apply_train(
            params['trunk'], stats['trunk'], cfg['trunk_cfg'], img,
            features=True)
    else:
        feats = resnet.apply(params['trunk'], stats['trunk'],
                             cfg['trunk_cfg'], img, features=True)
        trunk_stats = None
    rn = [cnn.conv2d(params[f'scratch{i}'], feats[f'layer{i}'], padding=1)
          for i in range(1, 5)]
    path = _fusion_apply(params['refinenet4'], rn[3])
    for i in (3, 2, 1):
        path = _fusion_apply(params[f'refinenet{i}'], path, rn[i - 1])
    out = _conv_without_cudnn(params['out_conv1'], path)
    out = _upsample2x_half_pixel(out)
    out = torch.relu(cnn.conv2d(params['out_conv2'], out, padding=1))
    out = cnn.conv2d(params['out_conv3'], out)
    if cfg['non_negative']:
        out = torch.relu(out)
    return out[..., 0], feats, trunk_stats


def _order_branch_apply(branch_p, branch_s, bcfg, masks2ch, trunk_feats,
                        train=False):
    """Headless ResNet-50 over the (N, H, W, 2) masks, the trunk's
    layer1..3 features added to the input of stages 2..4
    (midas_net.py:91-99) -> (N, classes) logits; train=True: -> (logits,
    {'net': the branch's new statistics})."""
    net_p, net_s = branch_p['net'], branch_s['net']
    new_s: Dict[str, Any] = {}
    if train:
        h, new_s['bn1'] = resnet.run_stem(net_p, net_s, masks2ch, True)
        h, new_s['layer1'] = resnet.run_stage(net_p, net_s, bcfg, 1, h, True)
    else:
        h = resnet.run_stage(net_p, net_s, bcfg, 1,
                             resnet.run_stem(net_p, net_s, masks2ch))
    for li, key in ((2, 'layer1'), (3, 'layer2'), (4, 'layer3')):
        h = resnet.run_stage(net_p, net_s, bcfg, li, h + trunk_feats[key],
                             train)
        if train:
            h, new_s[f'layer{li}'] = h
    logits = cnn.linear(branch_p['fc'], cnn.avg_pool_global(h))
    return (logits, {'net': new_s}) if train else logits


def apply_disp(params, stats, cfg, img):
    """The disparity (N, H, W) of NHWC img, any variant: the trunk and the
    decoder only. It equals `apply`'s disparity, which the order branches
    do not touch (JAX's disparity forward runs them on zero masks and
    drops their logits)."""
    return _disp_path(params, stats, cfg, img)[0]


def _forward(params, stats, cfg, img, mask1, mask2, train):
    disp, feats, trunk_stats = _disp_path(params, stats, cfg, img, train)
    new_stats: Dict[str, Any] = {'trunk': trunk_stats}
    variant = cfg['variant']
    if variant == 'midas':
        return disp, new_stats
    m2 = torch.stack([mask1, mask2], dim=-1)
    branches = ('gdo',) if variant == 'instadepthnet_d' else ('do', 'oo')
    logits = []
    for b in branches:
        out = _order_branch_apply(params[b], stats[b], cfg[f'{b}_cfg'], m2,
                                  feats, train)
        if train:
            out, new_stats[b] = out
        logits.append(out)
    if variant == 'instadepthnet_d':
        return (disp, logits[0], None), new_stats
    return (disp, logits[0], logits[1]), new_stats


def apply(params, stats, cfg, img, mask1=None, mask2=None):
    """Eval forward. img (N, H, W, 3) normalised; masks (N, H, W).
    MidasNet -> disp (N, H, W); InstaDepthNet_d -> (disp, depth logits,
    None); InstaDepthNet_od -> (disp, depth logits, occlusion logits).
    (The JAX package's apply also returns the statistics and takes
    train; see `apply_train`.)"""
    return _forward(params, stats, cfg, img, mask1, mask2, False)[0]


def apply_train(params, stats, cfg, img, mask1=None, mask2=None):
    """Train-mode forward (the JAX package's `apply(..., train=True)`):
    every BatchNorm of the trunk and the order branches normalises with
    its batch statistics. Returns (out, new_stats): out as `apply`'s,
    new_stats the running statistics updated in a new tree with JAX's
    keys: 'trunk', and 'gdo' (InstaDepthNet_d) or 'do' and 'oo'
    (InstaDepthNet_od)."""
    return _forward(params, stats, cfg, img, mask1, mask2, True)
