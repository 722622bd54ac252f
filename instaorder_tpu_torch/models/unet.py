"""UNet family (the PCNet-M backbone), NHWC (counterpart of
instaorder_tpu/models/unet.py: `init`, `apply` with train=False and
train=True, `UNET_FACTORIES`).

Reference:
  UNet / UNetD2 / UNetD3 and the width factories  <- unet_model.py
  double_conv / down / up / outconv blocks       <- unet_parts.py
  UNetResNet (an RGB encoder at the bottleneck)  <- unet_resnet_model.py

Details kept from the JAX package (they fix the checkpoint layout and
the values):
  * the 3x3 convs have a bias (torch Conv2d's default), and outc is a
    biased 1x1;
  * `_max_pool2` is a 2x2 / 2 pool without padding, so odd sizes floor;
  * the up path: bilinear x2 with align_corners=True, padded to the
    skip's size (dy // 2 first), then concat [skip, x], skip first
    (unet_parts.py:76), then the double conv;
  * the *res variants run a headless resnet18 over the RGB patch, take
    its layer4, reduce it (1x1 conv, BN, ReLU), upsample it to the
    bottleneck's size and concatenate it after the bottleneck.

Every convolution is cuDNN f32 on the card (TF32 off,
`device.resolve_device`); the upsample is two f32 matmuls. The ReLUs
are `torch.relu` and the pools `_max_pool2`, looked up at call time, so
that a check can follow one branch of them (chip_smoke.py, the tests).
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..convert import tree_to
from ..core import nn as cnn
from ..ops.resize import upsample_bilinear_align_corners
from . import resnet


def _double_conv_init(gen, cin, cout, gain):
    p = {'conv1': cnn.conv_init(gen, 3, 3, cin, cout, bias=True,
                                init='xavier', gain=gain),
         'conv2': cnn.conv_init(gen, 3, 3, cout, cout, bias=True,
                                init='xavier', gain=gain)}
    s = {}
    p['bn1'], s['bn1'] = cnn.bn_init(cout)
    p['bn2'], s['bn2'] = cnn.bn_init(cout)
    return p, s


def _double_conv_apply(p, s, x, train):
    ns = {}
    x = cnn.conv2d(p['conv1'], x, padding=1)
    x, ns['bn1'] = cnn.batch_norm(p['bn1'], s['bn1'], x, train)
    x = torch.relu(x)
    x = cnn.conv2d(p['conv2'], x, padding=1)
    x, ns['bn2'] = cnn.batch_norm(p['bn2'], s['bn2'], x, train)
    return torch.relu(x), ns


def _max_pool2(x):
    return cnn.max_pool(x, window=2, stride=2, padding=0)


def _upsample_to(x, h, w):
    """NHWC x resized to (h, w): bilinear with align_corners=True."""
    return upsample_bilinear_align_corners(x.permute(0, 3, 1, 2), h,
                                           w).permute(0, 2, 3, 1)


def _up_apply(p, s, x, skip, train):
    """bilinear x2 (align corners) + pad to the skip + concat + double
    conv."""
    x = _upsample_to(x, x.shape[1] * 2, x.shape[2] * 2)
    dy = skip.shape[1] - x.shape[1]
    dx = skip.shape[2] - x.shape[2]
    if dy or dx:
        x = F.pad(x, (0, 0, dx // 2, dx - dx // 2, dy // 2, dy - dy // 2))
    return _double_conv_apply(p, s, torch.cat([skip, x], dim=-1), train)


def _stage_channels(depth: int, w: float):
    """The per-stage channel plan of unet_model.py's widths."""
    c = lambda m: int(m * w)   # noqa: E731
    if depth == 4:
        enc = [c(16), c(32), c(64), c(128), c(128)]
        ups = [(c(256), c(64)), (c(128), c(32)), (c(64), c(16)),
               (c(32), c(16))]
    elif depth == 3:
        enc = [c(16), c(32), c(64), c(64)]
        ups = [(c(128), c(32)), (c(64), c(16)), (c(32), c(16))]
    elif depth == 2:
        enc = [c(16), c(32), c(32)]
        ups = [(c(64), c(16)), (c(32), c(16))]
    else:
        raise ValueError(depth)
    return enc, ups


def init(gen, in_channels=3, w=4, n_classes=2, depth=4, gain=0.02,
         use_rgb_encoder=False, device='cpu'):
    """(params, stats, cfg) of UNet / UNetD3 / UNetD2 (depth 4 / 3 / 2),
    or of UNetResNet (use_rgb_encoder, depth 4). gen: a torch.Generator
    on the CPU (weights drawn there, then moved to `device`)."""
    enc, ups = _stage_channels(depth, w)
    p: Dict[str, Any] = {}
    s: Dict[str, Any] = {}
    p['inc'], s['inc'] = _double_conv_init(gen, in_channels, enc[0], gain)
    for i in range(1, len(enc)):
        p[f'down{i}'], s[f'down{i}'] = _double_conv_init(
            gen, enc[i - 1], enc[i], gain)
    rgb_cfg = None
    if use_rgb_encoder:
        if depth != 4:
            raise ValueError('the RGB encoder needs depth 4')
        p['image_encoder'], s['image_encoder'], rgb_cfg = resnet.init(
            gen, arch='resnet18', in_channels=3, with_head=False)
        p['reduce_conv'] = cnn.conv_init(gen, 1, 1, 512, int(128 * w),
                                         bias=True, init='xavier', gain=gain)
        p['reduce_bn'], s['reduce_bn'] = cnn.bn_init(int(128 * w))
        ups = [(int(384 * w), int(64 * w))] + ups[1:]
    for i, (cin, cout) in enumerate(ups, 1):
        p[f'up{i}'], s[f'up{i}'] = _double_conv_init(gen, cin, cout, gain)
    p['outc'] = cnn.conv_init(gen, 1, 1, ups[-1][1], n_classes, bias=True,
                              init='xavier', gain=gain)
    cfg = {'depth': depth, 'w': w, 'n_ups': len(ups),
           'use_rgb_encoder': use_rgb_encoder, 'rgb_cfg': rgb_cfg}
    return tree_to(p, device), tree_to(s, device), cfg


def _forward(params, stats, cfg, x, rgb, train):
    depth = cfg['depth']
    ns: Dict[str, Any] = {}
    h, ns['inc'] = _double_conv_apply(params['inc'], stats['inc'], x, train)
    feats = [h]
    for i in range(1, depth + 1):
        h, ns[f'down{i}'] = _double_conv_apply(
            params[f'down{i}'], stats[f'down{i}'], _max_pool2(h), train)
        feats.append(h)
    if cfg['use_rgb_encoder']:
        enc = resnet.apply_train if train else resnet.apply
        out = enc(params['image_encoder'], stats['image_encoder'],
                  cfg['rgb_cfg'], rgb, features=True)
        if train:
            rfeats, ns['image_encoder'] = out
        else:
            rfeats, ns['image_encoder'] = out, stats['image_encoder']
        img = cnn.conv2d(params['reduce_conv'], rfeats['layer4'])
        img, ns['reduce_bn'] = cnn.batch_norm(params['reduce_bn'],
                                              stats['reduce_bn'], img, train)
        img = _upsample_to(torch.relu(img), h.shape[1], h.shape[2])
        h = torch.cat([h, img], dim=-1)
    for i in range(1, cfg['n_ups'] + 1):
        h, ns[f'up{i}'] = _up_apply(params[f'up{i}'], stats[f'up{i}'], h,
                                    feats[depth - i], train)
    return cnn.conv2d(params['outc'], h), ns


def apply(params, stats, cfg, x, rgb=None):
    """Eval-mode forward. x: (N, H, W, C); rgb (the *res variants only):
    (N, H, W, 3). Returns the logits (N, H, W, n_classes)."""
    return _forward(params, stats, cfg, x, rgb, False)[0]


def apply_train(params, stats, cfg, x, rgb=None):
    """Train-mode forward (the JAX package's `apply(..., train=True)`):
    every BatchNorm normalises with its batch statistics. Returns
    (logits, new_stats), new_stats a new tree (`stats` is not
    written)."""
    return _forward(params, stats, cfg, x, rgb, True)


# the width factories of unet_model.py:78-109 / unet_resnet_model.py:46-59
UNET_FACTORIES = {
    'unet025': dict(w=0.25, depth=4), 'unet05': dict(w=0.5, depth=4),
    'unet1': dict(w=1, depth=4), 'unet2': dict(w=2, depth=4),
    'unet4': dict(w=4, depth=4),
    'unet1d2': dict(w=1, depth=2), 'unet2d2': dict(w=2, depth=2),
    'unet4d2': dict(w=4, depth=2),
    'unet1d3': dict(w=1, depth=3), 'unet2d3': dict(w=2, depth=3),
    'unet4d3': dict(w=4, depth=3),
    'unet025res': dict(w=0.25, depth=4, use_rgb_encoder=True),
    'unet05res': dict(w=0.5, depth=4, use_rgb_encoder=True),
    'unet1res': dict(w=1, depth=4, use_rgb_encoder=True),
    'unet2res': dict(w=2, depth=4, use_rgb_encoder=True),
    'unet4res': dict(w=4, depth=4, use_rgb_encoder=True),
}
