"""ResNet classifier family: init, the eval forward and the train
forward, NHWC.

Counterpart of instaorder_tpu/models/resnet.py: `init`; `apply` is its
`apply` with train=False (logits only, or with features=True the dict of
stage outputs), `apply_train` its `apply` with train=True ((out,
new_stats)); both share `_block_apply`, and so do `run_stem` and
`run_stage`, which the MiDaS order branches interleave with the trunk's
features (models/midas.py). The eval
forward is the f32 oracle that calibration runs
(models/quantize.calibrate_folded_resnet works on its folded form).
Parameter and statistics trees carry the same keys as the JAX pytrees.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..convert import tree_to
from ..core import nn as cnn

# arch name -> (block, layers, groups, width_per_group)
ARCHS = {
    'resnet18': ('basic', (2, 2, 2, 2), 1, 64),
    'resnet34': ('basic', (3, 4, 6, 3), 1, 64),
    'resnet50': ('bottleneck', (3, 4, 6, 3), 1, 64),
    'resnet101': ('bottleneck', (3, 4, 23, 3), 1, 64),
    'resnet152': ('bottleneck', (3, 8, 36, 3), 1, 64),
    'resnext50_32x4d': ('bottleneck', (3, 4, 6, 3), 32, 4),
    'resnext101_32x8d': ('bottleneck', (3, 4, 23, 3), 32, 8),
    'wide_resnet50_2': ('bottleneck', (3, 4, 6, 3), 1, 128),
    'wide_resnet101_2': ('bottleneck', (3, 4, 23, 3), 1, 128),
}

_EXPANSION = {'basic': 1, 'bottleneck': 4}


def _block_init(gen, block, cin, planes, stride, groups, base_width, init,
                gain):
    exp = _EXPANSION[block]
    kw = dict(init=init, gain=gain)
    p: Dict[str, Any] = {}
    s: Dict[str, Any] = {}
    if block == 'bottleneck':
        width = int(planes * (base_width / 64.0)) * groups
        p['conv1'] = cnn.conv_init(gen, 1, 1, cin, width, **kw)
        p['bn1'], s['bn1'] = cnn.bn_init(width)
        p['conv2'] = cnn.conv_init(gen, 3, 3, width, width, groups=groups,
                                   **kw)
        p['bn2'], s['bn2'] = cnn.bn_init(width)
        p['conv3'] = cnn.conv_init(gen, 1, 1, width, planes * exp, **kw)
        p['bn3'], s['bn3'] = cnn.bn_init(planes * exp)
    else:
        p['conv1'] = cnn.conv_init(gen, 3, 3, cin, planes, **kw)
        p['bn1'], s['bn1'] = cnn.bn_init(planes)
        p['conv2'] = cnn.conv_init(gen, 3, 3, planes, planes, **kw)
        p['bn2'], s['bn2'] = cnn.bn_init(planes)
    if stride != 1 or cin != planes * exp:
        p['down_conv'] = cnn.conv_init(gen, 1, 1, cin, planes * exp, **kw)
        p['down_bn'], s['down_bn'] = cnn.bn_init(planes * exp)
    return p, s


def init(gen, arch='resnet50', in_channels=3, num_classes=1000,
         weight_init='kaiming_out', gain=0.02, with_head=True,
         layers_override=None, device='cpu'):
    """Build (params, stats, static_cfg). gen: torch.Generator on the
    CPU (weights are drawn there and moved to `device`, so a seed gives
    the same tree on every device). with_head=False: no fc (the headless
    trunks of models/midas.py)."""
    block, layers, groups, base_width = ARCHS[arch]
    if layers_override is not None:
        layers = tuple(layers_override)
    exp = _EXPANSION[block]
    p: Dict[str, Any] = {}
    s: Dict[str, Any] = {}
    p['conv1'] = cnn.conv_init(gen, 7, 7, in_channels, 64, init=weight_init,
                               gain=gain)
    p['bn1'], s['bn1'] = cnn.bn_init(64)
    cin = 64
    for li, (planes, blocks) in enumerate(zip((64, 128, 256, 512), layers)):
        stage_p, stage_s = [], []
        for bi in range(blocks):
            stride = 2 if (li > 0 and bi == 0) else 1
            bp, bs = _block_init(gen, block, cin, planes, stride, groups,
                                 base_width, weight_init, gain)
            cin = planes * exp
            stage_p.append(bp)
            stage_s.append(bs)
        p[f'layer{li + 1}'] = stage_p
        s[f'layer{li + 1}'] = stage_s
    feat_dim = 512 * exp
    dual = isinstance(num_classes, (list, tuple))
    head_init = weight_init if weight_init == 'xavier' else 'torch_default'
    if with_head and dual:
        p['fc_occ'] = cnn.linear_init(gen, feat_dim, num_classes[0],
                                      init=head_init, gain=gain)
        p['fc_depth'] = cnn.linear_init(gen, feat_dim, num_classes[1],
                                        init=head_init, gain=gain)
    elif with_head:
        p['fc'] = cnn.linear_init(gen, feat_dim, num_classes,
                                  init=head_init, gain=gain)
    cfg = {'arch': arch, 'block': block, 'layers': layers, 'groups': groups,
           'base_width': base_width, 'feat_dim': feat_dim,
           'dual_head': dual}
    return tree_to(p, device), tree_to(s, device), cfg


def _vmask(x, valid_hw):
    """Zero everything of NHWC x beyond the (vh, vw) valid region."""
    if valid_hw is None:
        return x
    vh, vw = valid_hw
    h, w = x.shape[1], x.shape[2]
    if vh >= h and vw >= w:
        return x
    rows = torch.arange(h, device=x.device)[None, :, None, None] < vh
    cols = torch.arange(w, device=x.device)[None, None, :, None] < vw
    return torch.where(rows & cols, x, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def _block_apply(p, s, x, block, stride, groups, valid_hw=None,
                 train=False):
    """One residual block; returns (out, new_stats). train: batch
    statistics and updated running ones (core/nn.batch_norm); else the
    running statistics, returned as given. valid_hw: the (vh, vw) valid
    region of x for padded-bucket eval (see `apply`); x is zero beyond
    it. The input of the second 3x3 conv (the bottleneck's conv2, the
    basic block's conv2) and the block output are masked, as in the JAX
    package."""
    relu = torch.relu
    new_s = {}

    def bn(name, y):
        y, new_s[name] = cnn.batch_norm(p[name], s[name], y, train)
        return y

    identity = x
    out_hw = (None if valid_hw is None
              else (valid_hw[0] // stride, valid_hw[1] // stride))
    if block == 'bottleneck':
        out = relu(bn('bn1', cnn.conv2d(p['conv1'], x)))
        out = relu(bn('bn2', cnn.conv2d(p['conv2'], _vmask(out, valid_hw),
                                        stride=stride, padding=1,
                                        groups=groups)))
        out = bn('bn3', cnn.conv2d(p['conv3'], out))
    else:
        out = relu(bn('bn1', cnn.conv2d(p['conv1'], x, stride=stride,
                                        padding=1)))
        out = bn('bn2', cnn.conv2d(p['conv2'], _vmask(out, out_hw),
                                   padding=1))
    if 'down_conv' in p:
        identity = bn('down_bn', cnn.conv2d(p['down_conv'], x,
                                            stride=stride))
    return _vmask(relu(out + identity), out_hw), new_s


def _forward(params, stats, cfg, x, train, valid_hw, features=False):
    """(logits or (occ, depth), new_stats); with features=True the dict
    of stage outputs {stem, layer1..4, pooled} in place of the logits;
    see `apply`, `apply_train`."""
    new_stats = {}
    vhw = None
    if valid_hw is not None:
        vh, vw = int(valid_hw[0]), int(valid_hw[1])
        assert vh % 32 == 0 and vw % 32 == 0, valid_hw
    out = cnn.conv2d(params['conv1'], x, stride=2, padding=3)
    out, new_stats['bn1'] = cnn.batch_norm(params['bn1'], stats['bn1'], out,
                                           train)
    out = torch.relu(out)
    if valid_hw is not None:
        # post-relu values are >= 0, so zeroed pad rows cannot win the
        # max-pool over a valid window
        out = _vmask(out, (vh // 2, vw // 2))
        vhw = (vh // 4, vw // 4)
    out = _vmask(cnn.max_pool(out, 3, 2, 1), vhw)
    feats = {'stem': out}
    for li in range(4):
        name = f'layer{li + 1}'
        stage_new = []
        for bi, (bp, bs) in enumerate(zip(params[name], stats[name])):
            stride = 2 if (li > 0 and bi == 0) else 1
            out, bns = _block_apply(bp, bs, out, cfg['block'], stride,
                                    cfg['groups'], valid_hw=vhw,
                                    train=train)
            stage_new.append(bns)
            if vhw is not None:
                vhw = (vhw[0] // stride, vhw[1] // stride)
        new_stats[name] = stage_new
        feats[name] = out
    if vhw is None:
        pooled = cnn.avg_pool_global(out)
    else:
        pooled = (out.float().sum(dim=(1, 2)) / float(vhw[0] * vhw[1])
                  ).to(out.dtype)
    if features:
        feats['pooled'] = pooled
        return feats, new_stats
    if cfg['dual_head']:
        return (cnn.linear(params['fc_occ'], pooled),
                cnn.linear(params['fc_depth'], pooled)), new_stats
    return cnn.linear(params['fc'], pooled), new_stats


def apply(params, stats, cfg, x, valid_hw=None, features=False):
    """Eval-mode forward. x: (N, H, W, C) -> logits (or an (occ, depth)
    tuple for dual heads); features=True: the dict of stage outputs
    {stem, layer1..4, pooled} (NHWC; pooled (N, C)), which a headless
    tree (init with_head=False) gives as well.

    valid_hw: (vh, vw), Python ints, multiples of 32, for padded-bucket
    eval (eval/pipeline.py 'orig' mode): x is zero beyond [:vh, :vw] and
    the logits equal an exact-size (vh, vw) run. The valid region is
    re-zeroed after the stem relu, after the max-pool (whose pad row taps
    the last valid row), before every 3x3 conv and on every block
    output, and the global pool averages the valid region only."""
    return _forward(params, stats, cfg, x, False, valid_hw, features)[0]


def apply_train(params, stats, cfg, x, features=False):
    """Train-mode forward (the JAX package's `apply(..., train=True)`):
    every BatchNorm normalises with its batch statistics. x: (N, H, W,
    C) -> (logits or an (occ, depth) tuple, new_stats), new_stats the
    running statistics updated as core/nn.batch_norm updates them, in a
    new tree (`stats` is not written); features=True: the dict of stage
    outputs in place of the logits, as in `apply` (the UNet's RGB
    encoder, models/unet.py)."""
    return _forward(params, stats, cfg, x, True, None, features)


def run_stage(params, stats, cfg, stage_idx, x):
    """One residual stage (1-indexed, eval mode) on x -> out. The MiDaS
    order branches interleave trunk features between stages (reference
    midas/midas_net.py:91-99, 193-206)."""
    name = f'layer{stage_idx}'
    out = x
    for bi, (bp, bs) in enumerate(zip(params[name], stats[name])):
        stride = 2 if (stage_idx > 1 and bi == 0) else 1
        out, _ = _block_apply(bp, bs, out, cfg['block'], stride,
                              cfg['groups'], train=False)
    return out


def run_stem(params, stats, x):
    """conv1 + bn + relu + max-pool (eval mode) -> out."""
    out = cnn.conv2d(params['conv1'], x, stride=2, padding=3)
    out, _ = cnn.batch_norm(params['bn1'], stats['bn1'], out, False)
    return cnn.max_pool(torch.relu(out), 3, 2, 1)
