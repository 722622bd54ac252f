"""MiDaS / InstaDepthNet torch checkpoint conversion (counterpart of
instaorder_tpu/compat/torch_convert_midas.py).

Source name layout (reference midas/midas_net.py + blocks.py):
  pretrained.layer1.{0,1}           conv1 / bn1 of the ResNeXt trunk
  pretrained.layer1.4.<b>.*         trunk layer1 blocks
  pretrained.layer{2,3,4}.<b>.*     trunk stages
  scratch.layer{1..4}_rn.weight     reprojection convs (no bias)
  scratch.refinenet{1..4}.resConfUnit{1,2}.conv{1,2}.{weight,bias}
  scratch.output_conv.{0,2,4}.{weight,bias}
  do_net / oo_net / gdo_net.layer1.{0,1} + .layer1.4.<b> + .layer{2..4}.<b>
  depth_fc / occ_fc / fc            the order heads

The branch nets also appear under their original attribute names
(do_net.conv1.* etc.), because the reference aliases modules into the
Sequential; the canonical layerN names are read.
"""

from __future__ import annotations

from typing import Dict, Tuple

from .torch_convert import _t, bn, conv_b, conv_w, linear_w, strip_prefix


def _resnet_stages(sd, prefix, layers, stage_names, device):
    """The bottleneck stages whose blocks live at
    {prefix}{stage_names[i]}.<b>."""
    p: Dict = {}
    s: Dict = {}
    for li, (blocks, stage_prefix) in enumerate(zip(layers, stage_names)):
        stage_p, stage_s = [], []
        for bi in range(blocks):
            pre = f'{prefix}{stage_prefix}.{bi}'
            bp: Dict = {}
            bs: Dict = {}
            for ci in (1, 2, 3):
                bp[f'conv{ci}'] = {
                    'w': conv_w(sd[f'{pre}.conv{ci}.weight'], device)}
                bp[f'bn{ci}'], bs[f'bn{ci}'] = bn(sd, f'{pre}.bn{ci}',
                                                  device)
            if f'{pre}.downsample.0.weight' in sd:
                bp['down_conv'] = {
                    'w': conv_w(sd[f'{pre}.downsample.0.weight'], device)}
                bp['down_bn'], bs['down_bn'] = bn(
                    sd, f'{pre}.downsample.1', device)
            stage_p.append(bp)
            stage_s.append(bs)
        p[f'layer{li + 1}'] = stage_p
        s[f'layer{li + 1}'] = stage_s
    return p, s


def _headless_resnet(sd, prefix, layers, device):
    """A trunk or branch whose stem lives at {prefix}layer1.{0,1} and
    whose layer1 blocks at {prefix}layer1.4.<b> (the reference's
    Sequential repack, midas_net.py:48-49, 74, 150-151)."""
    p: Dict = {'conv1': {'w': conv_w(sd[f'{prefix}layer1.0.weight'],
                                     device)}}
    s: Dict = {}
    p['bn1'], s['bn1'] = bn(sd, f'{prefix}layer1.1', device)
    sp, ss = _resnet_stages(sd, prefix, layers,
                            ['layer1.4', 'layer2', 'layer3', 'layer4'],
                            device)
    p.update(sp)
    s.update(ss)
    return p, s


def _rcu(sd, pre, device):
    return {'conv1': conv_b(sd, f'{pre}.conv1', device),
            'conv2': conv_b(sd, f'{pre}.conv2', device)}


def midas_base_from_torch_state_dict(sd: Dict, cfg,
                                     device='cpu') -> Tuple[Dict, Dict]:
    """The disparity path only (trunk, scratch, refinenets, output
    convs): what the released MiDaS `model-f6b98070.pt` holds. Used for
    the training-time `pretrained_weight` ingest (reference
    midas/base_model.py:4-15 via midas_net.py:30-45): the order branches
    keep their init."""
    sd = strip_prefix(sd)
    p: Dict = {}
    s: Dict = {}
    p['trunk'], s['trunk'] = _headless_resnet(
        sd, 'pretrained.', tuple(cfg['trunk_cfg']['layers']), device)
    for i in range(1, 5):
        p[f'scratch{i}'] = {'w': conv_w(sd[f'scratch.layer{i}_rn.weight'],
                                        device)}
    for i in range(1, 5):
        pre = f'scratch.refinenet{i}'
        p[f'refinenet{i}'] = {'rcu1': _rcu(sd, f'{pre}.resConfUnit1', device),
                              'rcu2': _rcu(sd, f'{pre}.resConfUnit2', device)}
    for name, idx in (('out_conv1', 0), ('out_conv2', 2), ('out_conv3', 4)):
        p[name] = conv_b(sd, f'scratch.output_conv.{idx}', device)
    return p, s


def _branch(sd, net, fc, layers, device):
    bp, bs = _headless_resnet(sd, f'{net}.', layers, device)
    return ({'net': bp, 'fc': {'w': linear_w(sd[f'{fc}.weight'], device),
                               'b': _t(sd[f'{fc}.bias'], device)}},
            {'net': bs})


def midas_from_torch_state_dict(sd: Dict, cfg,
                                device='cpu') -> Tuple[Dict, Dict]:
    """-> (params, stats) for models/midas.apply. The stages' block counts
    come from the cfg of midas.init (so trimmed test nets convert too)."""
    sd = strip_prefix(sd)
    p, s = midas_base_from_torch_state_dict(sd, cfg, device)
    variant = cfg['variant']
    key = 'gdo_cfg' if variant == 'instadepthnet_d' else 'do_cfg'
    layers = tuple(cfg[key]['layers']) if key in cfg else (3, 4, 6, 3)
    if variant == 'instadepthnet_d':
        p['gdo'], s['gdo'] = _branch(sd, 'gdo_net', 'fc', layers, device)
    elif variant == 'instadepthnet_od':
        p['do'], s['do'] = _branch(sd, 'do_net', 'depth_fc', layers, device)
        p['oo'], s['oo'] = _branch(sd, 'oo_net', 'occ_fc', layers, device)
    return p, s
