"""Backbone registry (counterpart of instaorder_tpu/models/registry.py):
the reference's string dispatch (`backbone.__dict__[arch]`,
models/single_stage_model.py:24) so the experiment YAMLs resolve.

Each entry returns a dict with:
  init(gen, in_channels=3, num_classes=1000, weight_init='xavier',
       device=None, **backbone_param) -> (params, stats, cfg)
       gen: a torch.Generator (the JAX package takes a PRNG key);
       device None is the card (device.resolve_device), 'cpu' the CPU;
  apply(params, stats, cfg, x, valid_hw=None) -> logits (the port's
       eval-only resnet.apply; the JAX package's returns (out, stats)).

The UNet names (PCNet-M) and MidasNet / InstaDepthNet_d /
InstaDepthNet_od are registered so that they resolve by name, but their
networks are not ported yet: get_backbone raises NotImplementedError
for them (ROADMAP.md queue 1 item 4).
"""

from __future__ import annotations

from ..device import resolve_device
from . import resnet

BACKBONES = {}

# the keys of the JAX package's unet.UNET_FACTORIES (models/unet.py:158)
UNET_NAMES = ('unet025', 'unet05', 'unet1', 'unet2', 'unet4', 'unet1d2',
              'unet2d2', 'unet4d2', 'unet1d3', 'unet2d3', 'unet4d3',
              'unet025res', 'unet05res', 'unet1res', 'unet2res', 'unet4res')
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
        return {'init': init, 'apply': resnet.apply}
    return factory


def _not_ported(name):
    def factory():
        raise NotImplementedError(
            f"backbone '{name}' is not ported to instaorder_tpu_torch yet "
            '(ROADMAP.md queue 1 item 4: the UNet and MiDaS networks)')
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

for _name in UNET_NAMES + MIDAS_NAMES:
    register(_name)(_not_ported(_name))
