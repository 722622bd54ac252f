"""Inference-time BatchNorm folding and the folded ResNet forward
(counterpart of instaorder_tpu/models/folding.py: `fold_resnet`,
`swap_conv1_w`, `apply_folded`, `apply_folded_siamese`).

Eval-mode BN is an affine map, so it folds into the preceding conv:
  w' = w * gamma / sqrt(var + eps)      (per output channel)
  b' = beta - mean * gamma / sqrt(var + eps)

The folded forward routes blocks to the bf16 kernels (their f32 modes
for an f32 model) by `use_pallas` features, as the JAX package does
(`_apply_trunk`), among the stride-1
identity blocks with conv1 Cin <= IDEN_CIN_CAP first 'hwnc' (each block
-> ops/bottleneck_bf16_kernels `fused_bottleneck_hwnc`), then 'stage' /
'sstage' (each run of such blocks -> `fused_bottleneck_stage` /
`fused_bottleneck_stage_stream`, a run of one -> `fused_bottleneck`),
then 'identity' (`fused_bottleneck`); 'down' / 'down1' send the
projection blocks, all or stride 1 only, to `fused_bottleneck_down` and
'stem' the stem to ops/stem_kernels `fused_stem`. Everything else is the
plain conv chain (cuDNN on the card). The kernels take f32 biases, as
the TPU kernels cast them; the plain chain adds the bias in the compute
dtype, as jax does.
"""

from __future__ import annotations

import torch

from ..core import nn as cnn
from ..ops import bottleneck_bf16_kernels as bk16
from ..ops.gemm_layout import split_kmajor_f32
from ..ops.stem_kernels import (fused_stem, s2d_conv1_w, s2d_stem_input,
                                stem_kernel_weights)

# conv1 input channels up to which blocks go to the fused kernels
# (instaorder_tpu/ops/pallas_blocks.IDEN_CIN_CAP: layers 1-2 and the
# layer3 projection)
IDEN_CIN_CAP = 512


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


# `use_pallas` features: the JAX package's one vocabulary for every model
# path (bf16 here, v2 and int8c in models/quantize). Each path routes the
# names it uses and ignores the rest; an unknown name raises.
PALLAS_VOCAB = frozenset(('identity', 'stage', 'sstage', 'down', 'down1',
                          'down2', 'stem', 'stem2', 'qpool', 'hwnc',
                          'hwncs', 'hwncs1', 'hwncs1d', 'hwncp', 'dirpack'))
PALLAS_DEFAULT = frozenset(('identity',))


def _pallas_features(use_pallas, default=PALLAS_DEFAULT):
    """False -> no kernels; True / 'default' -> the path's `default`;
    else the explicit feature collection, which must lie in
    PALLAS_VOCAB."""
    if not use_pallas:
        return frozenset()
    if use_pallas is True or use_pallas == 'default':
        return default
    feats = frozenset(use_pallas)
    unknown = feats - PALLAS_VOCAB
    if unknown:
        raise ValueError(f'unknown pallas feature(s) {sorted(unknown)}; '
                         f'valid: {sorted(PALLAS_VOCAB)}')
    return feats


def _stem_fusable(w, x):
    """The fused stem covers the standard ResNet stem: 7x7, stride 2 +
    3x3/2 max-pool, spatial dims divisible by 4 (the JAX routing)."""
    return (w.shape[0] == 7 and w.shape[1] == 7 and
            x.shape[1] % 4 == 0 and x.shape[2] % 4 == 0)


def _plain_stem(conv1, x):
    """conv1 7x7/2 + relu + max-pool (cuDNN on the card)."""
    return cnn.max_pool(torch.relu(cnn.conv2d(conv1, x, stride=2,
                                              padding=3)), 3, 2, 1)


def _stem(conv1, x, feats):
    if 'stem' in feats and _stem_fusable(conv1['w'], x):
        return fused_stem(x.contiguous(), conv1['w'].contiguous(),
                          conv1['b'].float(), wk=conv1.get('wk'))
    return _plain_stem(conv1, x)


def add_stem_kernel_weights(conv1):
    """Give a stem's conv1 the weights the card's stem kernel reads
    (ops/stem_kernels `stem_kernel_weights`, in the layout of w's dtype:
    bf16, f32 or int8), once, when the model is built on the card: `wk`
    for the one-direction stem and `wk_siamese` for the double-width one
    (`siamese_conv1`). The JAX-layout `w` stays beside them for the plain
    versions. Returns conv1."""
    conv1['wk'] = stem_kernel_weights(conv1['w'])
    conv1['wk_siamese'] = stem_kernel_weights(
        siamese_conv1(conv1)['w'])
    return conv1


def add_f32_block_weights(tree):
    """Give every block of an f32 tree (a folded model left in f32, or a
    v2 model quantized at compute_dtype=f32) the weights the card's f32
    block kernel reads: `wk`, the split K-major (2, Cout, K) copies of
    w1, w2, w3 (and wd) (ops/gemm_layout.split_kmajor_f32), once, when
    the model is built on the card. The JAX-layout weights stay beside
    them for the plain versions. Returns tree."""
    for li in range(4):
        for bp in tree[f'layer{li + 1}']:
            bp['wk'] = [split_kmajor_f32(bp[c]['w'])
                        for c in ('conv1', 'conv2', 'conv3', 'down')
                        if c in bp]
    return tree


def _plain_block(bp, out, stride, block='bottleneck', groups=1):
    """One residual block as the plain conv chain (cuDNN on the card):
    every conv adds its bias in the compute dtype."""
    identity = out
    if block == 'bottleneck':
        h = torch.relu(cnn.conv2d(bp['conv1'], out))
        h = torch.relu(cnn.conv2d(bp['conv2'], h, stride=stride, padding=1,
                                  groups=groups))
        h = cnn.conv2d(bp['conv3'], h)
    else:
        h = torch.relu(cnn.conv2d(bp['conv1'], out, stride=stride,
                                  padding=1))
        h = cnn.conv2d(bp['conv2'], h, padding=1)
    if 'down' in bp:
        identity = cnn.conv2d(bp['down'], out, stride=stride)
    return torch.relu(h + identity)


def _unpack(c):
    return c['w'][0, 0].contiguous(), c['b'].float()


def _kernel_args(bp):
    """A bottleneck's weights as the bf16 kernels take them: 1x1 weights
    as (Cin, Cout) matrices, biases in f32 (the TPU kernels cast them);
    the projection's (wd, bd) last where the block has one."""
    args = (*_unpack(bp['conv1']), bp['conv2']['w'],
            bp['conv2']['b'].float(), *_unpack(bp['conv3']))
    return args + _unpack(bp['down']) if 'down' in bp else args


def _apply_trunk(params, cfg, out, use_pallas=False):
    """Post-stem trunk + head of the folded ResNet (NHWC). Logits in
    f32: the pool is an f32 mean of the trunk output and the head runs
    on the (possibly bf16-rounded) fc weights widened to f32."""
    feats = _pallas_features(use_pallas)
    block, groups = cfg['block'], cfg['groups']
    fusable = block == 'bottleneck' and groups == 1

    def iden_ok(bp):
        return (fusable and 'down' not in bp
                and bp['conv1']['w'].shape[2] <= IDEN_CIN_CAP)

    for li in range(4):
        blocks = params[f'layer{li + 1}']
        bi = 0
        while bi < len(blocks):
            bp = blocks[bi]
            stride = 2 if (li > 0 and bi == 0) else 1
            small = fusable and bp['conv1']['w'].shape[2] <= IDEN_CIN_CAP
            wk = bp.get('wk')
            if 'hwnc' in feats and iden_ok(bp):
                out = bk16.fused_bottleneck_hwnc(out.contiguous(),
                                                 *_kernel_args(bp), wk=wk)
            elif feats & {'stage', 'sstage'} and iden_ok(bp):
                run = [bp]
                while bi + len(run) < len(blocks) and iden_ok(
                        blocks[bi + len(run)]):
                    run.append(blocks[bi + len(run)])
                if len(run) == 1:
                    out = bk16.fused_bottleneck(out.contiguous(),
                                                *_kernel_args(bp), wk=wk)
                else:
                    fn = (bk16.fused_bottleneck_stage_stream
                          if 'sstage' in feats else bk16.fused_bottleneck_stage)
                    out = fn(out.contiguous(), [_kernel_args(p) for p in run],
                             wk=[p.get('wk') for p in run])
                bi += len(run)
                continue
            elif small and 'down' in bp and (
                    'down' in feats or ('down1' in feats and stride == 1)):
                out = bk16.fused_bottleneck_down(
                    out.contiguous(), *_kernel_args(bp), stride=stride, wk=wk)
            elif 'identity' in feats and iden_ok(bp):
                out = bk16.fused_bottleneck(out.contiguous(),
                                            *_kernel_args(bp), wk=wk)
            else:
                out = _plain_block(bp, out, stride, block, groups)
            bi += 1
    pooled = out.float().mean(dim=(1, 2))
    head = lambda name: cnn.linear(cnn.tree_cast(params[name],
                                                 torch.float32), pooled)
    if cfg['dual_head']:
        return head('fc_occ'), head('fc_depth')
    return head('fc')


def apply_folded(params, cfg, x, dtype=None, use_pallas=False):
    """Inference forward of folded ResNet params (NHWC). dtype: compute
    dtype (torch.bfloat16 on the serving path); params are cast on the
    fly, logits come back in f32."""
    if dtype is not None:
        x = x.to(dtype)
        params = cnn.tree_cast(params, dtype)
    out = _stem(params['conv1'], x, _pallas_features(use_pallas))
    return _apply_trunk(params, cfg, out, use_pallas=use_pallas)


def siamese_conv1(conv1):
    """The double-width stem's conv1: both directions' weights on the
    output axis, [conv1 | swap_conv1_w(conv1)], and every per-channel
    leaf beside them (the bias; the int8c requant multiplier `m`) twice.
    The stem kernel's weights of the double-width stem, where the model
    has them (`add_stem_kernel_weights`), become its `wk`."""
    out = {k: torch.cat([v, v]) for k, v in conv1.items()
           if k not in ('w', 'wk', 'wk_siamese')}
    out['w'] = torch.cat([conv1['w'], swap_conv1_w(conv1['w'])],
                         dim=3).contiguous()
    if 'wk_siamese' in conv1:
        out['wk'] = conv1['wk_siamese']
    return out


def directions_to_batch(hcat):
    """Double-width stem output (N, H, W, 2C) -> (2N, H, W, C): the
    channel halves become the batch halves [direction 0; direction 1]."""
    c = hcat.shape[-1] // 2
    return torch.cat([hcat[..., :c], hcat[..., c:]], dim=0)


def siamese_forward(conv1, x, stem, trunk):
    """Both swap directions without a swapped input copy: pass 2's input
    is pass 1's with mask channels 0, 1 exchanged, and conv1(swap(x)) ==
    conv1'(x) for conv1' = swap_conv1_w(conv1). One double-width stem
    `stem(siamese_conv1(conv1), x)` reads x once; `trunk` runs once on
    the 2N batch [direction 0; direction 1], whose outputs (a tensor or
    a tuple of head outputs) are split back into (out1, out2)."""
    out = trunk(directions_to_batch(stem(siamese_conv1(conv1), x)))
    n = x.shape[0]
    if isinstance(out, tuple):
        return tuple(o[:n] for o in out), tuple(o[n:] for o in out)
    return out[:n], out[n:]


def apply_folded_siamese(params, cfg, x, dtype=None, use_pallas=False):
    """Both swap directions of `apply_folded` in one pass over the 2N
    batch (`siamese_forward`). Returns (out1, out2), each as
    `apply_folded` would return."""
    if dtype is not None:
        x = x.to(dtype)
        params = cnn.tree_cast(params, dtype)
    feats = _pallas_features(use_pallas)
    return siamese_forward(
        params['conv1'], x, lambda c1, x: _stem(c1, x, feats),
        lambda h: _apply_trunk(params, cfg, h, use_pallas=use_pallas))
