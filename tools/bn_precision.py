#!/usr/bin/env python3
"""How exact the port's train-mode forward is, and where its rounding
comes from.

    python tools/bn_precision.py --cpu    # needs the JAX package
    python tools/bn_precision.py --card   # on the GPU, no JAX

--cpu: the UNet (unet05 at 37^2, batch 3, the registry's init from seed
0, 0/1 mask inputs) in train mode: the max |logit| error, over max
|logit| of the port's float64 run, of JAX's f32 forward, of the port's
(`core/nn.batch_norm`: F.batch_norm on a contiguous NCHW copy on the
CPU) and of the port with its BatchNorm input left as the channels-last
view of the NHWC tensor (PyTorch's channels-last CPU kernel, which
normalises as x * a + b).

--card: chip_smoke.py phase 6's one-step batch (InstaOrderNet_o,
ResNet-50, 4 pairs at 256^2) in train mode on the card: for each
BatchNorm, its new running statistics against those computed in float64
from the same f32 input (the statistics' own rounding), and for each
convolution its output against the same convolution in float64 on the
same input (its own rounding); the worst of each, and the median conv.
"""

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def cpu():
    import jax
    import torch.nn.functional as F
    from instaorder_tpu.models import unet as JU
    from instaorder_tpu_torch import convert
    from instaorder_tpu_torch.core.nn import tree_cast
    from instaorder_tpu_torch.models import registry, unet as TU
    jax.config.update('jax_platforms', 'cpu')
    p, s, cfg = registry.get_backbone('unet05')['init'](
        torch.Generator().manual_seed(0), in_channels=2, n_classes=2,
        device='cpu')
    rng = np.random.RandomState(5)
    x = np.zeros((3, 37, 37, 2), np.float32)
    for i in range(3):
        for c in range(2):
            y0, x0 = rng.randint(0, 18, 2)
            x[i, y0:y0 + 18, x0:x0 + 14, c] = 1
    exact, _ = TU.apply_train(tree_cast(p, torch.float64),
                              tree_cast(s, torch.float64), cfg,
                              torch.from_numpy(x).double())
    scale = float(exact.abs().max())

    def err(y):
        y = torch.as_tensor(np.asarray(y)).double()
        return float((y - exact).abs().max()) / scale
    jy, _ = JU.apply(convert.to_numpy(p), convert.to_numpy(s), cfg, x,
                     train=True)
    with torch.no_grad():
        ty, _ = TU.apply_train(p, s, cfg, torch.from_numpy(x))
        real = F.batch_norm
        F.batch_norm = lambda x, *a, **k: real(
            x.contiguous(memory_format=torch.channels_last), *a, **k)
        try:
            cy, _ = TU.apply_train(p, s, cfg, torch.from_numpy(x))
        finally:
            F.batch_norm = real
    print(f'unet05 train forward, max |error| / max |logit| against the '
          f"port's f64 run: JAX f32 {err(jy):.3e}, port f32 {err(ty):.3e}, "
          f'port f32 with a channels-last BatchNorm input {err(cy):.3e}')


def card():
    import chip_smoke as CS
    from instaorder_tpu_torch.core import nn as cnn
    from instaorder_tpu_torch.data import synthetic
    from instaorder_tpu_torch.data.datasets import DATASETS, collate
    from instaorder_tpu_torch.data.loader import sample_rng
    from instaorder_tpu_torch.device import resolve_device
    from instaorder_tpu_torch.models.registry import get_backbone
    from instaorder_tpu_torch.train import algos
    from instaorder_tpu_torch.train import trainer as T
    dev = resolve_device()
    print(CS.card_line())
    root = tempfile.mkdtemp()
    insta, _, img = synthetic.make_instaorder_fixture(
        root, n_images=CS.TESTER_IMAGES, n_instances=CS.TESTER_INSTANCES,
        h=CS.HEIGHT, w=CS.WIDTH)
    args = CS.train_args('InstaOrderNet_o', (insta, img), 1)
    net = get_backbone('resnet50_cls')
    params, stats, cfg = net['init'](
        torch.Generator().manual_seed(0), weight_init='kaiming_out',
        device=dev, **args.model['backbone_param'])
    ds = DATASETS[args.data['trainval_dataset']](args.data, 'train',
                                                 args.model['algo'])
    batch = collate([ds.sample(i % len(ds), sample_rng(0, i))
                     for i in range(CS.XDEV_PAIRS)])
    bns, convs = [], []
    real_bn, real_conv = cnn.batch_norm, cnn.conv2d

    def bn(p, s, x, train, momentum=0.1, eps=1e-5):
        y, ns = real_bn(p, s, x, train, momentum, eps)
        xd = x.detach().double()
        n = xd.numel() // xd.shape[-1]
        var = xd.var(dim=(0, 1, 2), unbiased=False) * (n / (n - 1))
        ev = (1 - momentum) * s['var'].double() + momentum * var
        bns.append(float((ns['var'].double() - ev).abs().max() /
                         ev.abs().max()))
        return y, ns

    def conv(prm, x, **kw):
        y = real_conv(prm, x, **kw)
        y64 = real_conv({k: v.detach().double() for k, v in prm.items()},
                        x.detach().double(), **kw)
        convs.append(float((y.detach().double() - y64).abs().max() /
                           y64.abs().max()))
        return y
    cnn.batch_norm, cnn.conv2d = bn, conv
    try:
        with torch.no_grad():
            algos.make_loss(args.model['algo'], net, cfg, args.model)(
                params, stats, T.batch_to_device(batch, dev), True)
    finally:
        cnn.batch_norm, cnn.conv2d = real_bn, real_conv
    print(f'phase 6 batch, train forward on the card: the new running var '
          f'of {len(bns)} BatchNorms within {max(bns):.3e} of f64 from the '
          f'same input (worst); {len(convs)} convolutions within '
          f'{max(convs):.3e} of f64 on the same input (worst), median '
          f'{float(np.median(convs)):.3e}')


if __name__ == '__main__':
    ap = argparse.ArgumentParser()
    ap.add_argument('--cpu', action='store_true')
    ap.add_argument('--card', action='store_true')
    a = ap.parse_args()
    if a.cpu:
        cpu()
    if a.card:
        card()
