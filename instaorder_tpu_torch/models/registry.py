"""Backbone registry (counterpart of instaorder_tpu/models/registry.py):
the reference's string dispatch (`backbone.__dict__[arch]`,
models/single_stage_model.py:24) so the experiment YAMLs resolve.

Each entry returns a dict with:
  init(gen, in_channels=3, num_classes=1000, weight_init='xavier',
       device=None, **backbone_param) -> (params, stats, cfg)
       gen: a torch.Generator (the JAX package takes a PRNG key);
       device None is the card (device.resolve_device), 'cpu' the CPU;
  apply(params, stats, cfg, x, valid_hw=None) -> logits (the port's
       eval resnet.apply; the JAX package's returns (out, stats));
  apply_train(params, stats, cfg, x) -> (out, new_stats) (the JAX
       package's apply with train=True).

MidasNet / InstaDepthNet_d / InstaDepthNet_od (models/midas.py) take
`init(gen, device=None, **kw)` (in_channels and num_classes dropped, as
in the JAX package) and `apply(params, stats, cfg, img, mask1=None,
mask2=None)`; they are eval-only (no apply_train: their training is
not ported). The UNet family (PCNet-M, models/unet.py) takes
`init(gen, in_channels=3, n_classes=2, device=None, **extra)` (the rest
of backbone_param ignored, as in the JAX package), `apply(params,
stats, cfg, x, rgb=None)` and `apply_train(params, stats, cfg, x,
rgb=None)`.
"""

from __future__ import annotations

from ..device import resolve_device
from . import midas, resnet, unet

BACKBONES = {}

UNET_NAMES = tuple(unet.UNET_FACTORIES)
MIDAS_NAMES = ('MidasNet', 'InstaDepthNet_d', 'InstaDepthNet_od')


def register(name):
    def deco(factory):
        BACKBONES[name] = factory
        return factory
    return deco


def get_backbone(name):
    if name not in BACKBONES:
        raise KeyError(
            f"unknown backbone '{name}'; have {sorted(BACKBONES)}")
    return BACKBONES[name]()


def _resnet_entry(arch):
    def factory():
        def init(gen, in_channels=3, num_classes=1000, weight_init='xavier',
                 device=None, **kw):
            return resnet.init(gen, arch=arch, in_channels=in_channels,
                               num_classes=num_classes,
                               weight_init=weight_init,
                               device=resolve_device(device), **kw)
        return {'init': init, 'apply': resnet.apply,
                'apply_train': resnet.apply_train}
    return factory


def _midas_entry(variant):
    def factory():
        def init(gen, device=None, **kw):
            kw.pop('in_channels', None)
            kw.pop('num_classes', None)
            return midas.init(gen, variant=variant,
                              device=resolve_device(device), **kw)
        return {'init': init, 'apply': midas.apply}
    return factory


def _unet_entry(name):
    def factory():
        kw = unet.UNET_FACTORIES[name]

        def init(gen, in_channels=3, n_classes=2, device=None, **extra):
            return unet.init(gen, in_channels=in_channels,
                             n_classes=n_classes,
                             device=resolve_device(device), **kw)
        return {'init': init, 'apply': unet.apply,
                'apply_train': unet.apply_train}
    return factory


# reference names (resnet_cls.py factories; `resnet50_cls` is the headline)
for _name, _arch in [
    ('resnet18_cls', 'resnet18'),
    ('resnet34_cls', 'resnet34'),
    ('resnet50_cls', 'resnet50'),
    ('resnet101', 'resnet101'),
    ('resnet152', 'resnet152'),
    ('resnext50_32x4d', 'resnext50_32x4d'),
    ('resnext101_32x8d', 'resnext101_32x8d'),
    ('wide_resnet50_2', 'wide_resnet50_2'),
    ('wide_resnet101_2', 'wide_resnet101_2'),
]:
    register(_name)(_resnet_entry(_arch))

# UNet family (PCNet-M backbones, unet_model.py:78-109 + the *res variants)
for _name in UNET_NAMES:
    register(_name)(_unet_entry(_name))

# MiDaS family (midas/midas_net.py)
for _name, _variant in zip(MIDAS_NAMES, midas.VARIANTS):
    register(_name)(_midas_entry(_variant))
