"""Legacy deocclusion nets that the reference carries and its shipped configs
do not use (counterpart of instaorder_tpu/models/legacy.py):

  AE / VAE (+AE256/AE32/VAE32)       <- models/backbone/vae.py
  PartialConv / PCBActiv / PConvUNet <- models/backbone/pconv_unet.py
  InpaintDiscriminator / NLayerDiscriminator (spectral-norm PatchGAN)
                                     <- models/backbone/discriminator.py
  VGG16 enc_1..enc_3 extractor       <- pconv_unet.py:33-51

Plain functions on NHWC tensors over the JAX package's trees (the same
keys, HWIO weights): `*_init(gen, ...)` draws from a torch.Generator on
the CPU and moves the tree to `device`; `*_apply(params, stats, cfg, x,
train=False)` returns (output, new_stats) as JAX's does, train=True
normalising every BatchNorm with its batch statistics
(core/nn.batch_norm; `stats` is never written).

Spectral norm is weight / sigma_max from one power-iteration step on the
vector `u` carried in stats (torch's eval form); train=True returns the
refreshed `u`, eval the old one. As in the JAX package, the gradient
flows through the power iteration (torch's own spectral_norm runs it
without gradient). The VAE's reparameterisation noise comes from `rng`
(a torch.Generator standing for JAX's PRNG key) or is passed in as
`eps`. A PConvUNet block keeps its sampling mode as a string leaf
(`'sample': 'down-7'`), which convert.to_torch / to_numpy pass through.

Every convolution is cuDNN f32 on the card (TF32 off,
device.resolve_device); no hand-written kernel is reached, as JAX's
counterparts reach no Pallas kernel.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..convert import tree_to
from ..core import nn as cnn
from .unet import (_double_conv_apply, _double_conv_init, _max_pool2,
                   _upsample_to)


def _up2_align(x):
    return _upsample_to(x, x.shape[1] * 2, x.shape[2] * 2)


def _leaky(x):
    return F.leaky_relu(x, 0.2)


# ---------------------------------------------------------------------------
# AE / VAE
# ---------------------------------------------------------------------------

# vae.py's AE256 / AE32 / VAE32 (the JAX package names them in its
# docstring only): the names' latent sizes at ae_init's default width; the
# input is 256^2 at every width (the bottleneck is 16^2 after four pools)
AE_FACTORIES = {'AE256': dict(w=4, latent_dim=256),
                'AE32': dict(w=4, latent_dim=32),
                'VAE32': dict(w=4, latent_dim=32, variational=True)}


def ae_init(gen, in_channels=3, w=4, latent_dim=256, n_classes=2,
            variational=False, device='cpu'):
    c = lambda m: int(m * w)  # noqa: E731
    p: Dict[str, Any] = {}
    s: Dict[str, Any] = {}
    p['inc'], s['inc'] = _double_conv_init(gen, in_channels, c(16), 0.02)
    p['down1'], s['down1'] = _double_conv_init(gen, c(16), c(32), 0.02)
    p['down2'], s['down2'] = _double_conv_init(gen, c(32), c(64), 0.02)
    p['down3'], s['down3'] = _double_conv_init(gen, c(64), c(64), 0.02)
    flat = int(16384 * w)
    if variational:
        p['mean_linear'] = cnn.linear_init(gen, flat, latent_dim)
        p['var_linear'] = cnn.linear_init(gen, flat, latent_dim)
    else:
        p['enc_linear'] = cnn.linear_init(gen, flat, latent_dim)
    p['dec_linear'] = cnn.linear_init(gen, latent_dim, flat)
    p['up1'], s['up1'] = _double_conv_init(gen, c(64), c(32), 0.02)
    p['up2'], s['up2'] = _double_conv_init(gen, c(32), c(16), 0.02)
    p['up3'], s['up3'] = _double_conv_init(gen, c(16), n_classes, 0.02)
    cfg = {'w': w, 'latent_dim': latent_dim, 'variational': variational}
    return tree_to(p, device), tree_to(s, device), cfg


def ae_apply(params, stats, cfg, x, train=False, rng=None, eps=None):
    """x: (N, 256, 256, C). Returns (logits, new_stats) for the AE and
    ((logits, mean, logvar), new_stats) for the VAE. The VAE samples z =
    eps * exp(logvar / 2) + mean in train mode, eps drawn from `rng` (a
    torch.Generator) or given; without either, and in eval mode, z is
    the mean."""
    ns: Dict[str, Any] = {}
    h, ns['inc'] = _double_conv_apply(params['inc'], stats['inc'], x, train)
    for i in (1, 2, 3):
        h, ns[f'down{i}'] = _double_conv_apply(
            params[f'down{i}'], stats[f'down{i}'], _max_pool2(h), train)
    h = _max_pool2(h)
    n = h.shape[0]
    flat = h.reshape(n, -1)
    if cfg['variational']:
        mean = cnn.linear(params['mean_linear'], flat)
        logvar = cnn.linear(params['var_linear'], flat)
        if train and eps is None and rng is not None:
            eps = torch.randn(mean.shape, generator=rng, device=rng.device,
                              dtype=mean.dtype)
        if not train or eps is None:
            eps = torch.zeros_like(mean)
        z = eps.to(mean) * torch.exp(0.5 * logvar) + mean
    else:
        z = torch.relu(cnn.linear(params['enc_linear'], flat))
    h = torch.relu(cnn.linear(params['dec_linear'], z))
    h = h.reshape(n, 16, 16, -1)
    for i in (1, 2, 3):
        h, ns[f'up{i}'] = _double_conv_apply(
            params[f'up{i}'], stats[f'up{i}'], _up2_align(h), train)
    out = _up2_align(h)
    if cfg['variational']:
        return (out, mean, logvar), ns
    return out, ns


# ---------------------------------------------------------------------------
# partial convolutions (mask-normalised conv)
# ---------------------------------------------------------------------------

def partial_conv(conv_p, x, mask, stride=1, padding=0):
    """PartialConv forward (pconv_unet.py:70-95): the conv of x * mask
    divided by the window's mask coverage, plus the bias; 0 where the
    window holds no valid pixel (a hole), and the new mask 1 elsewhere.
    mask has x's shape. The coverage (the conv of the mask with a kernel
    of ones) is summed over the channels first and convolved once: the
    same integers, exact in f32."""
    out = cnn.conv2d({'w': conv_p['w']}, x * mask, stride=stride,
                     padding=padding)
    k = conv_p['w'].shape[0]
    ones = torch.ones((k, k, 1, 1), dtype=mask.dtype, device=mask.device)
    mask_sum = cnn.conv2d({'w': ones}, mask.sum(-1, keepdim=True),
                          stride=stride, padding=padding)
    holes = mask_sum == 0
    mask_sum = torch.where(holes, torch.ones_like(mask_sum), mask_sum)
    out = out / mask_sum
    if 'b' in conv_p:
        out = out + conv_p['b']
    out = torch.where(holes, torch.zeros_like(out), out)
    new_mask = torch.where(holes, torch.zeros_like(out),
                           torch.ones_like(out))
    return out, new_mask


# sampling mode -> (kernel, stride, padding)
_SAMPLES = {'down-7': (7, 2, 3), 'down-5': (5, 2, 2), 'down-3': (3, 2, 1),
            'none-3': (3, 1, 1)}


def pconv_unet_init(gen, layer_size=7, input_channels=3, device='cpu'):
    p: Dict[str, Any] = {}
    s: Dict[str, Any] = {}

    def pcb(cin, cout, sample, bn=True, bias=False):
        ksz, _, _ = _SAMPLES[sample]
        blk = {'conv': cnn.conv_init(gen, ksz, ksz, cin, cout, bias=bias,
                                     init='kaiming_out'),
               'sample': sample}
        st = {}
        if bn:
            blk['bn'], st['bn'] = cnn.bn_init(cout)
        return blk, st

    p['enc_1'], s['enc_1'] = pcb(input_channels, 64, 'down-7', bn=False)
    p['enc_2'], s['enc_2'] = pcb(64, 128, 'down-5')
    p['enc_3'], s['enc_3'] = pcb(128, 256, 'down-5')
    p['enc_4'], s['enc_4'] = pcb(256, 512, 'down-3')
    for i in range(4, layer_size):
        p[f'enc_{i + 1}'], s[f'enc_{i + 1}'] = pcb(512, 512, 'down-3')
        p[f'dec_{i + 1}'], s[f'dec_{i + 1}'] = pcb(1024, 512, 'none-3')
    p['dec_4'], s['dec_4'] = pcb(512 + 256, 256, 'none-3')
    p['dec_3'], s['dec_3'] = pcb(256 + 128, 128, 'none-3')
    p['dec_2'], s['dec_2'] = pcb(128 + 64, 64, 'none-3')
    p['dec_1'], s['dec_1'] = pcb(64 + input_channels, 3, 'none-3', bn=False,
                                 bias=True)
    return tree_to(p, device), tree_to(s, device), {'layer_size': layer_size}


def _pcb_apply(blk, st, x, mask, train, activ='relu'):
    _, stride, pad = _SAMPLES[blk['sample']]
    h, m = partial_conv(blk['conv'], x, mask, stride, pad)
    new_st = dict(st)
    if 'bn' in blk:
        h, new_st['bn'] = cnn.batch_norm(blk['bn'], st['bn'], h, train)
    if activ == 'relu':
        h = torch.relu(h)
    elif activ == 'leaky':
        h = _leaky(h)
    return h, m, new_st


def _up2_nearest(x):
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def pconv_unet_apply(params, stats, cfg, x, mask, train=False):
    """x, mask: (N, H, W, C) with H, W divisible by 2^layer_size. Returns
    ((image, mask), new_stats)."""
    L = cfg['layer_size']
    ns: Dict[str, Any] = {}
    hs = {0: x}
    ms = {0: mask}
    for i in range(1, L + 1):
        hs[i], ms[i], ns[f'enc_{i}'] = _pcb_apply(
            params[f'enc_{i}'], stats[f'enc_{i}'], hs[i - 1], ms[i - 1],
            train)
    h, m = hs[L], ms[L]
    for i in range(L, 0, -1):
        h = torch.cat([_up2_nearest(h), hs[i - 1]], dim=-1)
        m = torch.cat([_up2_nearest(m), ms[i - 1]], dim=-1)
        activ = None if i == 1 else 'leaky'
        h, m, ns[f'dec_{i}'] = _pcb_apply(params[f'dec_{i}'],
                                          stats[f'dec_{i}'], h, m, train,
                                          activ)
    return (h, m), ns


# ---------------------------------------------------------------------------
# spectral-norm PatchGAN discriminators
# ---------------------------------------------------------------------------

def _sn_conv_init(gen, ksz, cin, cout, bias):
    p = cnn.conv_init(gen, ksz, ksz, cin, cout, bias=bias, init='xavier',
                      gain=0.02)
    u = torch.randn((cout,), generator=gen)
    return p, {'u': u / torch.linalg.norm(u)}


def _sn_conv_apply(p, st, x, stride, padding, train):
    w = p['w']
    cout = w.shape[-1]
    w2d = w.reshape(-1, cout)
    u = st['u']
    v = w2d @ u
    v = v / (torch.linalg.norm(v) + 1e-12)
    u_new = w2d.t() @ v
    u_new = u_new / (torch.linalg.norm(u_new) + 1e-12)
    sigma = v @ (w2d @ u_new)
    w_sn = {'w': w / sigma}
    if 'b' in p:
        w_sn['b'] = p['b']
    out = cnn.conv2d(w_sn, x, stride=stride, padding=padding)
    return out, {'u': u_new.detach() if train else u}


def inpaint_discriminator_init(gen, in_channels, use_spectral_norm=True,
                               device='cpu'):
    chans = [(in_channels, 64, 2), (64, 128, 2), (128, 256, 2),
             (256, 512, 1), (512, 1, 1)]
    p: Dict[str, Any] = {}
    s: Dict[str, Any] = {}
    for i, (cin, cout, _) in enumerate(chans, 1):
        p[f'conv{i}'], s[f'conv{i}'] = _sn_conv_init(
            gen, 4, cin, cout, bias=not use_spectral_norm)
    return tree_to(p, device), tree_to(s, device), {
        'strides': [st for _, _, st in chans], 'use_sigmoid': True}


def inpaint_discriminator_apply(params, stats, cfg, x, train=False):
    """Returns ((sigmoid output, [each conv's activation]), new_stats)."""
    ns = {}
    h = x
    feats = []
    for i, stride in enumerate(cfg['strides'], 1):
        h, ns[f'conv{i}'] = _sn_conv_apply(params[f'conv{i}'],
                                           stats[f'conv{i}'], h, stride, 1,
                                           train)
        if i < len(cfg['strides']):
            h = _leaky(h)
        feats.append(h)
    out = torch.sigmoid(h) if cfg['use_sigmoid'] else h
    return (out, feats), ns


def nlayer_discriminator_init(gen, input_nc, ndf=64, n_layers=3,
                              device='cpu'):
    """70x70 PatchGAN (discriminator.py:84-127) with spectral norm."""
    p: Dict[str, Any] = {}
    s: Dict[str, Any] = {}
    seq = [(input_nc, ndf, 2)]
    mult = 1
    for n in range(1, n_layers):
        prev, mult = mult, min(2 ** n, 8)
        seq.append((ndf * prev, ndf * mult, 2))
    prev, mult = mult, min(2 ** n_layers, 8)
    seq.append((ndf * prev, ndf * mult, 1))
    seq.append((ndf * mult, 1, 1))
    for i, (cin, cout, _) in enumerate(seq, 1):
        p[f'conv{i}'], s[f'conv{i}'] = _sn_conv_init(gen, 4, cin, cout,
                                                     bias=True)
    return tree_to(p, device), tree_to(s, device), {
        'strides': [st for _, _, st in seq]}


def nlayer_discriminator_apply(params, stats, cfg, x, train=False):
    """Returns (patch logits, new_stats)."""
    ns = {}
    h = x
    n = len(cfg['strides'])
    for i, stride in enumerate(cfg['strides'], 1):
        h, ns[f'conv{i}'] = _sn_conv_apply(params[f'conv{i}'],
                                           stats[f'conv{i}'], h, stride, 1,
                                           train)
        if i < n:
            h = _leaky(h)
    return h, ns


# ---------------------------------------------------------------------------
# VGG16 feature extractor (perceptual / style losses)
# ---------------------------------------------------------------------------

# torchvision vgg16.features[:17] in three slices, each ending with a 2x2
# max pool: enc_1 = features[:5] (conv64 x2), enc_2 = [5:10] (conv128 x2),
# enc_3 = [10:17] (conv256 x3)
_VGG16_SLICES = ((64, 64), (128, 128), (256, 256, 256))
# the conv layers' indices in vgg16.features, per slice
_VGG16_TORCH_IDX = ((0, 2), (5, 7), (10, 12, 14))


def vgg16_extractor_init(gen, in_channels=3, device='cpu'):
    """VGG16 enc_1..enc_3 (reference pconv_unet.py:33-51) with random
    weights; `vgg16_from_torch_state_dict` converts real ones."""
    p: Dict[str, Any] = {}
    cin = in_channels
    for si, convs in enumerate(_VGG16_SLICES, 1):
        blocks = []
        for cout in convs:
            blocks.append(cnn.conv_init(gen, 3, 3, cin, cout, bias=True,
                                        init='kaiming_out'))
            cin = cout
        p[f'enc_{si}'] = blocks
    return tree_to(p, device), {'slices': tuple(len(c) for c in
                                                _VGG16_SLICES)}


def vgg16_extractor_apply(params, cfg, image_nhwc):
    """-> [enc_1, enc_2, enc_3] feature maps (each after its 2x2 / 2 max
    pool, as torchvision's vgg16.features slices)."""
    results = []
    h = image_nhwc
    for si in range(1, len(cfg['slices']) + 1):
        for conv_p in params[f'enc_{si}']:
            h = torch.relu(cnn.conv2d(conv_p, h, padding=1))
        h = _max_pool2(h)
        results.append(h)
    return results


def vgg16_from_torch_state_dict(sd, device='cpu'):
    """torchvision vgg16.features[:17] weights (keys 'features.<i>.weight'
    / '.bias') -> the extractor's tree."""
    from ..compat.torch_convert import conv_b
    return {f'enc_{si}': [conv_b(sd, f'features.{li}', device)
                          for li in idxs]
            for si, idxs in enumerate(_VGG16_TORCH_IDX, 1)}
