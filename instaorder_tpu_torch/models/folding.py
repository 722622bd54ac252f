"""Inference-time BatchNorm folding (counterpart of
instaorder_tpu/models/folding.py: `fold_resnet`, `swap_conv1_w`).

Eval-mode BN is an affine map, so it folds into the preceding conv:
  w' = w * gamma / sqrt(var + eps)      (per output channel)
  b' = beta - mean * gamma / sqrt(var + eps)
"""

from __future__ import annotations

import torch


def _fold(conv_p, bn_p, bn_s, eps=1e-5):
    scale = bn_p['scale'] * torch.rsqrt(bn_s['var'] + eps)
    w = conv_p['w'] * scale  # HWIO: broadcast over output channel (last)
    b = bn_p['bias'] - bn_s['mean'] * scale
    if 'b' in conv_p:
        b = b + conv_p['b'] * scale
    return {'w': w, 'b': b}


def fold_resnet(params, stats, cfg):
    """ResNet (bottleneck family) params+stats -> folded conv-only
    params."""
    out = {'conv1': _fold(params['conv1'], params['bn1'], stats['bn1'])}
    for li in range(len(cfg['layers'])):
        name = f'layer{li + 1}'
        stage = []
        for bp, bs in zip(params[name], stats[name]):
            fb = {f'conv{ci}': _fold(bp[f'conv{ci}'], bp[f'bn{ci}'],
                                     bs[f'bn{ci}'])
                  for ci in (1, 2, 3)}
            if 'down_conv' in bp:
                fb['down'] = _fold(bp['down_conv'], bp['down_bn'],
                                   bs['down_bn'])
            stage.append(fb)
        out[name] = stage
    for fc in ('fc', 'fc_occ', 'fc_depth'):
        if fc in params:
            out[fc] = params[fc]
    return out


def swap_conv1_w(w):
    """conv1 weights with input-channel rows 0,1 exchanged (HWIO axis 2):
    conv1(swap(x)) == conv1'(x) for the pair-mask channel swap."""
    perm = [1, 0] + list(range(2, w.shape[2]))
    return w[:, :, perm, :]
