"""The plain reference of the InstaOrder ResNet-50 nets, in float32.

Written from the published description (torchvision's ResNet-50 with a
5-channel stem, InstaOrderNet's heads) and the port's documented
serving scheme, with no code of the program: NHWC activations and HWIO
weights, the parameter tree the benchmark makes (`portbench/weights.py`).

  fold             eval-mode BatchNorm folded into each convolution
  forward_folded   the f32 eval forward of the folded net (pooled
                   features, or the heads' logits)
  calibrate_v2     absmax / 127 at the stem and at every block output
  quantize_v2      the boundary-int8 ("v2") model: weights in bf16 with
                   the boundary scales folded in, f32 biases
  forward_v2       its forward: int8 values at the stem and block
                   boundaries, bf16 values inside a block, every sum in
                   f32 over operands already rounded to bf16
  forward_train    the train-mode forward (batch statistics)

Every convolution and matrix product runs in float32 with TF32 off.
Inside `tf32()` they run in TF32 instead (on the card TF32 itself, on
the CPU the operands rounded to TF32's 10-bit mantissa): that is the
control, the next precision below the one the configurations state.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

LAYERS = (3, 4, 6, 3)
PLANES = (64, 128, 256, 512)
EXPANSION = 4
EPS = 1e-5

_TF32 = [False]


@contextlib.contextmanager
def tf32(on=True):
    """Products in TF32 inside the block (the control), else f32."""
    old = (_TF32[0], torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    _TF32[0] = on
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (_TF32[0], torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def round_tf32(x):
    """x rounded to the nearest TF32 value (10 mantissa bits)."""
    i = x.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def _operands(*xs):
    """The operands of a product: on the CPU inside `tf32()` rounded to
    TF32 (the gradient passed straight through)."""
    if _TF32[0] and xs[0].device.type == 'cpu':
        return tuple(x + (round_tf32(x.detach()) - x.detach()) for x in xs)
    return xs


def conv(x, w, stride=1, padding=0):
    """NHWC x, HWIO w -> NHWC, f32 (TF32 inside `tf32()`)."""
    x, w = _operands(x, w)
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def matmul(a, b):
    a, b = _operands(a, b)
    return a @ b


def max_pool(x):
    return F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)


def blocks(tree):
    """(stage index, block index, stride, block) over the trunk."""
    for li in range(4):
        for bi, bp in enumerate(tree[f'layer{li + 1}']):
            yield li, bi, (2 if li > 0 and bi == 0 else 1), bp


def heads(tree, pooled):
    """The logits of the net's head(s): one tensor, or (occ, depth)."""
    if 'fc_occ' in tree:
        return tuple(matmul(pooled, tree[k]['w']) + tree[k]['b']
                     for k in ('fc_occ', 'fc_depth'))
    return matmul(pooled, tree['fc']['w']) + tree['fc']['b']


# ---------------------------------------------------------------------------
# folding and the f32 eval forward
# ---------------------------------------------------------------------------

def _fold(w, bn, st):
    scale = bn['scale'] * torch.rsqrt(st['var'] + EPS)
    return {'w': w * scale, 'b': bn['bias'] - st['mean'] * scale}


def fold(params, stats):
    """Eval-mode BatchNorm folded into each conv: w * g / sqrt(v + eps),
    b = beta - mean * g / sqrt(v + eps)."""
    out = {'conv1': _fold(params['conv1']['w'], params['bn1'],
                          stats['bn1'])}
    for li in range(4):
        name = f'layer{li + 1}'
        stage = []
        for bp, bs in zip(params[name], stats[name]):
            fb = {f'conv{c}': _fold(bp[f'conv{c}']['w'], bp[f'bn{c}'],
                                    bs[f'bn{c}']) for c in (1, 2, 3)}
            if 'down_conv' in bp:
                fb['down'] = _fold(bp['down_conv']['w'], bp['down_bn'],
                                   bs['down_bn'])
            stage.append(fb)
        out[name] = stage
    for k in ('fc', 'fc_occ', 'fc_depth'):
        if k in params:
            out[k] = params[k]
    return out


def _conv_b(p, x, stride=1, padding=0):
    return conv(x, p['w'], stride, padding) + p['b']


def stem_f32(folded, x):
    return max_pool(torch.relu(_conv_b(folded['conv1'], x, 2, 3)))


def block_f32(bp, x, stride):
    h = torch.relu(_conv_b(bp['conv1'], x))
    h = torch.relu(_conv_b(bp['conv2'], h, stride, 1))
    y = _conv_b(bp['conv3'], h)
    idn = _conv_b(bp['down'], x, stride) if 'down' in bp else x
    return torch.relu(y + idn)


@torch.no_grad()
def forward_folded(folded, x, features=False):
    """The f32 eval forward of a folded net on an NHWC batch: the pooled
    features (features=True) or the heads' logits."""
    h = stem_f32(folded, x.float())
    for _li, _bi, stride, bp in blocks(folded):
        h = block_f32(bp, h, stride)
    pooled = h.mean(dim=(1, 2))
    return pooled if features else heads(folded, pooled)


# ---------------------------------------------------------------------------
# the boundary-int8 (v2) model
# ---------------------------------------------------------------------------

def _absmax(x):
    return x.abs().amax().float()


@torch.no_grad()
def calibrate_v2(folded, x, chunk=256):
    """Boundary scales from the f32 folded forward over the calibration
    batch x: absmax / 127 (floored at 1e-8) after the stem's pool and
    at every block output, as Python floats of f32 values."""
    stem = None
    for i in range(0, int(x.shape[0]), chunk):
        h = stem_f32(folded, x[i:i + chunk].float())
        a = [_absmax(h)]
        for _li, _bi, stride, bp in blocks(folded):
            h = block_f32(bp, h, stride)
            a.append(_absmax(h))
        a = torch.stack(a)
        stem = a if stem is None else torch.maximum(stem, a)
    vals = torch.clamp(stem.cpu() / 127.0, min=1e-8)
    return [float(v) for v in vals]


def quantize_v2(folded, scales):
    """The v2 model: conv1 w / s_stem; each block with boundary scales
    s_in, s_out: conv1 w * s_in, conv3 w / s_out and b / s_out, the
    projection w * s_in / s_out and b / s_out, an identity block's
    residual factor r = s_in / s_out; weights rounded to bf16, biases
    f32, the heads as they are; s_feat the last boundary's scale."""
    bf = torch.bfloat16

    def w_(a, mul=1.0):
        return (a.float() * mul).to(bf)

    def b_(a, mul=1.0):
        return a.float() * mul

    s_stem = scales[0]
    q = {'conv1': {'w': w_(folded['conv1']['w'], 1.0 / s_stem),
                   'b': b_(folded['conv1']['b'], 1.0 / s_stem)}}
    s_prev = s_stem
    k = 1
    for li in range(4):
        stage = []
        for bp in folded[f'layer{li + 1}']:
            s_out = scales[k]
            k += 1
            qb = {'conv1': {'w': w_(bp['conv1']['w'], s_prev),
                            'b': b_(bp['conv1']['b'])},
                  'conv2': {'w': w_(bp['conv2']['w']),
                            'b': b_(bp['conv2']['b'])},
                  'conv3': {'w': w_(bp['conv3']['w'], 1.0 / s_out),
                            'b': b_(bp['conv3']['b'], 1.0 / s_out)}}
            if 'down' in bp:
                qb['down'] = {'w': w_(bp['down']['w'], s_prev / s_out),
                              'b': b_(bp['down']['b'], 1.0 / s_out)}
            else:
                qb['r'] = float(torch.tensor(s_prev / s_out,
                                             dtype=torch.float32))
            stage.append(qb)
            s_prev = s_out
        q[f'layer{li + 1}'] = stage
    for name in ('fc', 'fc_occ', 'fc_depth'):
        if name in folded:
            q[name] = {k2: v.float() for k2, v in folded[name].items()}
    q['s_feat'] = float(torch.tensor(s_prev, dtype=torch.float32))
    return q


def _bf(x):
    """x rounded to bf16, held in f32."""
    return x.to(torch.bfloat16).float()


def _q8(y):
    return torch.clamp(torch.round(torch.relu(y)), 0.0, 127.0)


def _block_v2(qb, x, stride):
    """x: int8 values 0..127 held in f32 -> the block's int8 output (f32)."""
    w = {k: qb[k]['w'].float() for k in ('conv1', 'conv2', 'conv3')}
    h1 = _bf(torch.relu(conv(x, w['conv1']) + qb['conv1']['b']))
    h2 = _bf(torch.relu(conv(h1, w['conv2'], stride, 1) + qb['conv2']['b']))
    y = conv(h2, w['conv3']) + qb['conv3']['b']
    if 'down' in qb:
        y = y + conv(x, qb['down']['w'].float(), stride) + qb['down']['b']
    else:
        y = y + x * qb['r']
    return _q8(y)


@torch.no_grad()
def forward_v2(q, x):
    """The v2 forward of an NHWC batch (its values already in bf16): the
    stem conv's sum rounded to bf16 before its f32 bias, relu, bf16,
    3x3/2 max-pool, then int8; the blocks as `_block_v2`; the mean of
    the last int8 plane times s_feat; the f32 heads."""
    c1 = q['conv1']
    h = _bf(conv(_bf(x.float()), c1['w'].float(), 2, 3)) + c1['b']
    h = _q8(max_pool(_bf(torch.relu(h))))
    for _li, _bi, stride, qb in blocks(q):
        h = _block_v2(qb, h, stride)
    return heads(q, (h * q['s_feat']).mean(dim=(1, 2)))


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _bn_train(bn, x):
    """Train-mode BatchNorm over (N, H, W) with the batch's statistics
    (biased variance), f32."""
    xc = x.permute(0, 3, 1, 2)
    if xc.device.type == 'cpu':
        # the CPU kernel normalises a channels-last view as x * a + b,
        # which cancels where |mean| >> std; its contiguous kernel
        # computes (x - mean) * a
        xc = xc.contiguous()
    y = F.batch_norm(xc, None, None, bn['scale'], bn['bias'], training=True,
                     eps=EPS)
    return y.permute(0, 2, 3, 1)


def forward_train(params, x):
    """The train-mode forward of an unfolded net (autograd through it):
    every BatchNorm normalises with its batch statistics."""
    h = conv(x, params['conv1']['w'], 2, 3)
    h = max_pool(torch.relu(_bn_train(params['bn1'], h)))
    for _li, _bi, stride, bp in blocks(params):
        o = torch.relu(_bn_train(bp['bn1'], conv(h, bp['conv1']['w'])))
        o = torch.relu(_bn_train(bp['bn2'], conv(o, bp['conv2']['w'],
                                                 stride, 1)))
        o = _bn_train(bp['bn3'], conv(o, bp['conv3']['w']))
        idn = (_bn_train(bp['down_bn'], conv(h, bp['down_conv']['w'],
                                             stride))
               if 'down_conv' in bp else h)
        h = torch.relu(o + idn)
    return heads(params, h.mean(dim=(1, 2)))
