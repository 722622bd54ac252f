"""PyTorch checkpoint -> the port's weight trees (counterpart of
instaorder_tpu/compat/torch_convert.py).

The reference ships 14 released `.pth.tar` checkpoints plus the MiDaS
`model-f6b98070.pt` (reference README.md:53-67, midas/base_model.py:4-15).
This module maps their state_dict names onto the port's trees, which
keep the JAX package's layout:

  torch OIHW conv weight      -> HWIO  (permute 2, 3, 1, 0)
  torch (out, in) linear      -> (in, out)
  bn {weight,bias,running_*}  -> params {scale,bias} / stats {mean,var}

Checkpoint dicts are `{step, state_dict, optimizer}` with a `module.`
prefix from the reference's DistModule wrapper (single_stage_model.py:
66-72). Every converter puts its tensors on the `device` it is given
(the CPU by default); the values and dtypes are the file's.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def _t(t, device='cpu'):
    """A state_dict value (tensor or array) as a tensor on `device`."""
    if isinstance(t, torch.Tensor):
        return t.detach().to(device)
    return torch.as_tensor(np.asarray(t), device=device)


def conv_w(t, device='cpu'):
    return _t(t, device).permute(2, 3, 1, 0).contiguous()  # OIHW -> HWIO


def linear_w(t, device='cpu'):
    return _t(t, device).t().contiguous()


def bn(sd, name, device='cpu'):
    """BatchNorm `name` of `sd` -> (params {scale, bias}, stats {mean,
    var})."""
    params = {'scale': _t(sd[f'{name}.weight'], device),
              'bias': _t(sd[f'{name}.bias'], device)}
    stats = {'mean': _t(sd[f'{name}.running_mean'], device),
             'var': _t(sd[f'{name}.running_var'], device)}
    return params, stats


def conv_b(sd, name, device='cpu'):
    """A biased conv `name` of `sd` -> {'w': HWIO, 'b'}."""
    return {'w': conv_w(sd[f'{name}.weight'], device),
            'b': _t(sd[f'{name}.bias'], device)}


def strip_prefix(sd: Dict, prefix: str = 'module.') -> Dict:
    return {(k[len(prefix):] if k.startswith(prefix) else k): v
            for k, v in sd.items()}


def resnet_from_torch_state_dict(sd: Dict, cfg, lenient: bool = False,
                                 device='cpu') -> Tuple[Dict, Dict]:
    """A torch resnet_cls-style state_dict -> (params, stats) for
    models/resnet.apply; `cfg` is the static cfg of resnet.init. conv1
    takes the checkpoint's channel count (3 or 5). A single fc, the dual
    fc_occ / fc_depth heads and headless dicts are all read.

    lenient: skip (rather than raise on) the components whose keys are
    missing: a partial state_dict (pruned or backbone-only, or BN without
    running statistics) converts to a partial tree that
    core/checkpoint._lenient_merge fills from the init, the reference's
    load_state_dict(strict=False) subset load (resnet_cls.py:227-232)."""
    sd = strip_prefix(sd)
    p: Dict = {}
    s: Dict = {}

    def put(fn):
        try:
            fn()
        except KeyError:
            if not lenient:
                raise

    put(lambda: p.__setitem__('conv1', {'w': conv_w(sd['conv1.weight'],
                                                    device)}))

    def put_bn(pd, sdict, pk, name):
        # field by field, so that a state_dict without running statistics
        # (or without the affine params) still loads the keys it has:
        # torch's load_state_dict(strict=False) loads tensor by tensor
        def field(dst, key, src):
            def go():
                v = _t(sd[src], device)         # may raise KeyError
                dst.setdefault(pk, {})[key] = v  # before the subdict exists
            put(go)
        field(pd, 'scale', f'{name}.weight')
        field(pd, 'bias', f'{name}.bias')
        field(sdict, 'mean', f'{name}.running_mean')
        field(sdict, 'var', f'{name}.running_var')

    put_bn(p, s, 'bn1', 'bn1')
    n_convs = 3 if cfg['block'] == 'bottleneck' else 2
    for li, blocks in enumerate(cfg['layers']):
        stage_p, stage_s = [], []
        for bi in range(blocks):
            pre = f'layer{li + 1}.{bi}'
            bp: Dict = {}
            bs: Dict = {}
            for ci in range(1, n_convs + 1):
                put(lambda ci=ci: bp.__setitem__(
                    f'conv{ci}',
                    {'w': conv_w(sd[f'{pre}.conv{ci}.weight'], device)}))
                put_bn(bp, bs, f'bn{ci}', f'{pre}.bn{ci}')
            if f'{pre}.downsample.0.weight' in sd:
                put(lambda: bp.__setitem__(
                    'down_conv',
                    {'w': conv_w(sd[f'{pre}.downsample.0.weight'], device)}))
                put_bn(bp, bs, 'down_bn', f'{pre}.downsample.1')
            stage_p.append(bp)
            stage_s.append(bs)
        p[f'layer{li + 1}'] = stage_p
        s[f'layer{li + 1}'] = stage_s
    for fc in ('fc', 'fc_occ', 'fc_depth'):
        if f'{fc}.weight' in sd:
            put(lambda fc=fc: p.__setitem__(
                fc, {'w': linear_w(sd[f'{fc}.weight'], device),
                     'b': _t(sd[f'{fc}.bias'], device)}))
    return p, s


def _state_dict(blob):
    return (blob['state_dict'] if isinstance(blob, dict) and
            'state_dict' in blob else blob)


def _convert(sd, cfg, family, device, lenient=False):
    if family == 'resnet':
        return resnet_from_torch_state_dict(sd, cfg, lenient=lenient,
                                            device=device)
    if family == 'midas_base':
        from .torch_convert_midas import midas_base_from_torch_state_dict
        return midas_base_from_torch_state_dict(sd, cfg, device)
    if family == 'midas':
        from .torch_convert_midas import midas_from_torch_state_dict
        return midas_from_torch_state_dict(sd, cfg, device)
    if family == 'unet':
        from .torch_convert_unet import unet_from_torch_state_dict
        return unet_from_torch_state_dict(sd, cfg, device)
    raise ValueError(family)


def load_pretrain(path, params, stats, cfg, family='resnet', warn=print,
                  device='cpu'):
    """Pretrained ingest for training, the reference's `load_pretrain`
    (main.py:38-39 + models/backbone/resnet_cls.py:227-232 strict=False,
    models/single_stage_model.py:63-64): a torch state_dict mapped onto
    the initialised (params, stats), the init kept, with a warning,
    wherever the checkpoint lacks a key or its shape differs (an ImageNet
    3-channel conv1 against a 5-channel net, a 1000-way fc against the
    order heads).

    family: 'resnet' for the order nets (torchvision / ImageNet or the
    released `.pth.tar` state_dicts, read leniently), 'midas_base' for the
    MiDaS `model-f6b98070.pt` disparity path (midas/base_model.py:4-15;
    the order branches keep their init), 'unet' / 'midas' for full-model
    dicts. device: where the loaded tensors go, that of `params`.
    Returns (params, stats)."""
    from ..core.checkpoint import _lenient_merge
    # weights_only=False, as the JAX package passes: the reference's
    # released .pth.tar files pickle more than tensors
    blob = torch.load(path, map_location='cpu', weights_only=False)
    p_t, s_t = _convert(_state_dict(blob), cfg, family, device,
                        lenient=True)
    params = _lenient_merge(params, p_t, 'params', warn)
    stats = _lenient_merge(stats, s_t, 'stats', warn)
    return params, stats


def convert_checkpoint(path, cfg, family: str = 'resnet', device='cpu'):
    """A reference `.pth.tar` (or `.pt`) converted strictly (a missing
    key raises). Returns (params, stats, step)."""
    # weights_only=True: the JAX package's call passes no value, and the
    # PyTorch of the GPU machine (2.6 and later) defaults to True
    blob = torch.load(path, map_location='cpu', weights_only=True)
    step = blob.get('step', 0) if isinstance(blob, dict) else 0
    params, stats = _convert(_state_dict(blob), cfg, family, device)
    return params, stats, step
