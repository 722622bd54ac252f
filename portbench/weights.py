"""Seeded weights for a configuration, made on the device in a few large
draws, in the unfolded tree layout the port's builders take (NHWC
nets, HWIO conv weights; per block conv1, bn1, conv2, bn2, conv3, bn3
and the projection's down_conv, down_bn). The program and the reference
get the same tree.

Convolutions: kaiming normal over fan-out (torchvision's ResNet
initialisation), which keeps the activations alive through the trunk.
BatchNorm: scale in [0.5, 1.5), bias and running mean in [-0.1, 0.1),
running variance in [0.5, 1.5), so that folding them changes every
convolution; the last BatchNorm of each residual branch (bn3) has its
scale times a gain (the configuration's `bn3_gain`), near the
zero-initialised residual of torchvision's `zero_init_residual` (Goyal
et al., 2017). At full gain a random ResNet-50 is chaotic: a rounding
that flips at one block boundary doubles, block by block (measured on
the CPU: 1e-5 of the values at the stem, 0.2 by layer4), and the
int8-boundary model's answers are then set by its summation order. Heads: `default_heads` draws torch.nn.Linear's default
(training); `centred_heads` draws random directions and scales each
logit to the spread of its values over the pooled features of a batch,
its bias cancelling their mean, so that the logits over pairs have mean
0 and a spread of `spread` and decisions go both ways (an eval net with
random weights otherwise gives every pair the same answer).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .reference.model import EXPANSION, LAYERS, PLANES

FEAT = 512 * EXPANSION
RESIDUAL_GAIN = 0.01


def subseed(seed, tag):
    """A 63-bit seed for one use (`tag`) of the run's seed."""
    ss = np.random.SeedSequence([int(seed) % 2 ** 64, int(tag)])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed, tag, device):
    g = torch.Generator(device=device)
    g.manual_seed(subseed(seed, tag))
    return g


def _shapes(in_ch, gain):
    """(conv shapes HWIO, (BN width, scale gain)), both in tree order."""
    convs, bns = [(7, 7, in_ch, 64)], [(64, 1.0)]
    cin = 64
    for planes, n in zip(PLANES, LAYERS):
        for bi in range(n):
            cout = planes * EXPANSION
            convs += [(1, 1, cin, planes), (3, 3, planes, planes),
                      (1, 1, planes, cout)]
            bns += [(planes, 1.0), (planes, 1.0), (cout, gain)]
            if bi == 0:
                convs.append((1, 1, cin, cout))
                bns.append((cout, 1.0))
            cin = cout
    return convs, bns


def make_trunk(seed, device, in_ch=5, gain=RESIDUAL_GAIN):
    """(params, stats) of a headless ResNet-50 from `seed`: two draws;
    `gain` the bn3 scale factor."""
    g = generator(seed, 1, device)
    convs, bns = _shapes(in_ch, gain)
    flat = torch.randn(sum(math.prod(s) for s in convs), generator=g,
                       device=device)
    ws, k = [], 0
    for s in convs:
        n = math.prod(s)
        fan_out = s[0] * s[1] * s[3]
        ws.append(flat[k:k + n].view(s) * math.sqrt(2.0 / fan_out))
        k += n
    u = torch.rand(4 * sum(c for c, _ in bns), generator=g, device=device)
    bn, k = [], 0
    for c, gain in bns:
        a, b, m, v = u[k:k + 4 * c].view(4, c)
        bn.append(({'scale': (a + 0.5) * gain, 'bias': (b - 0.5) * 0.2},
                   {'mean': (m - 0.5) * 0.2, 'var': v + 0.5}))
        k += 4 * c
    wi, bi_ = iter(ws), iter(bn)
    params, stats = {}, {}
    params['conv1'] = {'w': next(wi)}
    params['bn1'], stats['bn1'] = next(bi_)
    for li, n in enumerate(LAYERS):
        sp, ss = [], []
        for bi in range(n):
            p, s = {}, {}
            for c in (1, 2, 3):
                p[f'conv{c}'] = {'w': next(wi)}
                p[f'bn{c}'], s[f'bn{c}'] = next(bi_)
            if bi == 0:
                p['down_conv'] = {'w': next(wi)}
                p['down_bn'], s['down_bn'] = next(bi_)
            sp.append(p)
            ss.append(s)
        params[f'layer{li + 1}'], stats[f'layer{li + 1}'] = sp, ss
    return params, stats


def head_names(num_classes):
    if isinstance(num_classes, (list, tuple)):
        return list(zip(('fc_occ', 'fc_depth'), num_classes))
    return [('fc', num_classes)]


def default_heads(params, seed, num_classes, device):
    """torch.nn.Linear's default initialisation of each head."""
    g = generator(seed, 2, device)
    bound = 1.0 / math.sqrt(FEAT)
    for name, c in head_names(num_classes):
        u = torch.rand(FEAT * c + c, generator=g, device=device)
        u = (u * 2.0 - 1.0) * bound
        params[name] = {'w': u[:FEAT * c].view(FEAT, c), 'b': u[FEAT * c:]}
    return params


def centred_heads(params, seed, num_classes, pooled, spread=2.0):
    """Heads over the pooled features (B, 2048) of a batch: random
    directions, each logit scaled so that its values over that batch
    have mean 0 and standard deviation `spread`."""
    g = generator(seed, 3, pooled.device)
    mu = pooled.mean(0)
    for name, c in head_names(num_classes):
        w = torch.randn(FEAT, c, generator=g, device=pooled.device)
        w = w * (spread / ((pooled - mu) @ w).std(0))
        params[name] = {'w': w, 'b': -(mu @ w)}
    return params
