"""UNet (PCNet-M) torch checkpoint conversion (counterpart of
instaorder_tpu/compat/torch_convert_unet.py).

Source name layout (reference models/backbone/unet/):
  inc.conv.conv.{0,1,3,4}           double_conv (conv, bn, conv, bn)
  down<i>.mpconv.1.conv.{0,1,3,4}   max-pool + double_conv
  up<i>.conv.conv.{0,1,3,4}
  outc.conv.{weight,bias}
  image_encoder.* / reduce_dim.{0,1}  (UNetResNet only)
"""

from __future__ import annotations

from typing import Dict, Tuple

from .torch_convert import (bn, conv_b, resnet_from_torch_state_dict,
                            strip_prefix)


def _double_conv(sd, pre, device):
    p = {'conv1': conv_b(sd, f'{pre}.0', device),
         'conv2': conv_b(sd, f'{pre}.3', device)}
    s = {}
    p['bn1'], s['bn1'] = bn(sd, f'{pre}.1', device)
    p['bn2'], s['bn2'] = bn(sd, f'{pre}.4', device)
    return p, s


def unet_from_torch_state_dict(sd: Dict, cfg,
                               device='cpu') -> Tuple[Dict, Dict]:
    """-> (params, stats) for models/unet.apply."""
    sd = strip_prefix(sd)
    p: Dict = {}
    s: Dict = {}
    p['inc'], s['inc'] = _double_conv(sd, 'inc.conv.conv', device)
    for i in range(1, cfg['depth'] + 1):
        p[f'down{i}'], s[f'down{i}'] = _double_conv(
            sd, f'down{i}.mpconv.1.conv', device)
    # the reference's UNetD3 names its ups up2..up4, UNet / UNetD2
    # up1..: renumbered from 1
    up_keys = sorted(k.split('.')[0] for k in sd
                     if k.startswith('up') and k.endswith('conv.0.weight'))
    for i, src in enumerate(up_keys, 1):
        p[f'up{i}'], s[f'up{i}'] = _double_conv(sd, f'{src}.conv.conv',
                                                device)
    p['outc'] = conv_b(sd, 'outc.conv', device)
    if cfg.get('use_rgb_encoder'):
        enc_sd = {k[len('image_encoder.'):]: v for k, v in sd.items()
                  if k.startswith('image_encoder.')}
        p['image_encoder'], s['image_encoder'] = \
            resnet_from_torch_state_dict(enc_sd, cfg['rgb_cfg'],
                                         device=device)
        p['reduce_conv'] = conv_b(sd, 'reduce_dim.0', device)
        p['reduce_bn'], s['reduce_bn'] = bn(sd, 'reduce_dim.1', device)
    return p, s
