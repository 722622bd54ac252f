"""Boundary-int8 ("v2") post-training quantization of the folded ResNet
serving trunk (counterpart of instaorder_tpu/models/quantize.py, v2 path).

int8 is only the storage format at block boundaries — the stem output
and every bottleneck output hold integers 0..127 — while all arithmetic
inside a block runs in the compute dtype (bf16 on the card, f32 in the
CPU tests). Scale algebra per block with boundary scales s_in / s_out:
  conv1 w *= s_in          (the int8 input feeds the matmul directly)
  conv3 w /= s_out, b /= s_out
  down  w *= s_in / s_out, b /= s_out
  identity residual: + x_int8 * (s_in / s_out)
  output: clip(round(relu(.)), 0, 127) -> int8
The stem folds 1/s_stem into conv1.

Routing matches the JAX package's default kernel set: all of layer1 (the
stride-1 projection and its identity run) is one stage call, the three
stride-2 projections go to the stride-2 kernel and the remaining
identity blocks to the identity kernel (ops/bottleneck_kernels.py).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..core import nn as cnn
from ..ops import bottleneck_kernels as bk

# calibration forward chunk (images per forward): bounds the f32
# forward's activation memory; absmax is chunk-associative
CAL_CHUNK = 512


def _absmax(x):
    return x.abs().amax().float()


def calibrate_folded_resnet(folded, cfg, xs):
    """Run the f32 folded forward on sample batch(es) `xs` (list of
    (N, H, W, C) f32 tensors, already prep-normalized) recording absmax
    at every quantization boundary. Returns a scales tree of Python
    floats (f32 values: absmax/127, floored at 1e-8)."""
    if not isinstance(xs, (list, tuple)):
        xs = [xs]
    assert cfg['block'] == 'bottleneck', 'int8 path targets resnet50-family'
    relu = torch.relu

    def one_batch(x):
        rec: Dict[str, Any] = {'in': _absmax(x)}
        out = relu(cnn.conv2d(folded['conv1'], x, stride=2, padding=3))
        out = cnn.max_pool(out, 3, 2, 1)
        rec['stem'] = _absmax(out)
        for li in range(4):
            rl = []
            for bi, bp in enumerate(folded[f'layer{li + 1}']):
                stride = 2 if (li > 0 and bi == 0) else 1
                identity = out
                h = relu(cnn.conv2d(bp['conv1'], out))
                r = {'h1': _absmax(h)}
                h = relu(cnn.conv2d(bp['conv2'], h, stride=stride,
                                    padding=1, groups=cfg['groups']))
                r['h2'] = _absmax(h)
                hh = cnn.conv2d(bp['conv3'], h)
                if 'down' in bp:
                    identity = cnn.conv2d(bp['down'], out, stride=stride)
                out = relu(hh + identity)
                r['out'] = _absmax(out)
                rl.append(r)
            rec[f'layer{li + 1}'] = rl
        return rec

    def merge(a, b):
        if isinstance(a, dict):
            return {k: merge(a[k], b[k]) for k in a}
        if isinstance(a, list):
            return [merge(u, v) for u, v in zip(a, b)]
        return torch.maximum(a, b)

    def finish(a):
        if isinstance(a, dict):
            return {k: finish(v) for k, v in a.items()}
        if isinstance(a, list):
            return [finish(v) for v in a]
        return float(torch.clamp(a.cpu() / 127.0, min=1e-8))

    merged = None
    with torch.no_grad():
        for x in xs:
            for i in range(0, int(x.shape[0]), CAL_CHUNK):
                rec = one_batch(x[i:i + CAL_CHUNK].float())
                merged = rec if merged is None else merge(merged, rec)
    return finish(merged)


def quantize_folded_v2(folded, cfg, scales, compute_dtype=torch.bfloat16):
    """folded f32 params + boundary calibration scales (only 'stem' and
    the per-block 'out' entries are used) -> v2 serving params:
    compute-dtype weights with boundary scales folded, f32 biases, and
    the Python-float scalars `r` (identity blocks) and `s_feat`."""
    cdt = compute_dtype

    def _w(a, mul=1.0):
        return (a.float() * mul).to(cdt).contiguous()

    def _b(a, mul=1.0):
        return (a.float() * mul).contiguous()

    s_stem = float(scales['stem'])
    q: Dict[str, Any] = {
        'conv1': {'w': _w(folded['conv1']['w'], 1.0 / s_stem),
                  'b': _b(folded['conv1']['b'], 1.0 / s_stem)},
    }
    s_prev = s_stem
    for li in range(4):
        name = f'layer{li + 1}'
        stage = []
        for bi, bp in enumerate(folded[name]):
            s_out = float(scales[name][bi]['out'])
            qb: Dict[str, Any] = {
                'conv1': {'w': _w(bp['conv1']['w'], s_prev),
                          'b': _b(bp['conv1']['b'])},
                'conv2': {'w': _w(bp['conv2']['w']),
                          'b': _b(bp['conv2']['b'])},
                'conv3': {'w': _w(bp['conv3']['w'], 1.0 / s_out),
                          'b': _b(bp['conv3']['b'], 1.0 / s_out)},
            }
            if 'down' in bp:
                qb['down'] = {'w': _w(bp['down']['w'], s_prev / s_out),
                              'b': _b(bp['down']['b'], 1.0 / s_out)}
            else:
                qb['r'] = float(np.float32(s_prev / s_out))
            stage.append(qb)
            s_prev = s_out
        q[name] = stage
    for fc in ('fc', 'fc_occ', 'fc_depth'):
        if fc in folded:
            q[fc] = {k: v.float() for k, v in folded[fc].items()}
    q['s_feat'] = float(np.float32(s_prev))
    return q


def _q8(y):
    """Pre-activation -> one-sided int8 boundary storage."""
    return torch.clamp(torch.round(torch.relu(y)), 0, 127).to(torch.int8)


def _stem_v2(q, x):
    """Compute-dtype stem conv (1/s_stem folded) + relu -> 3x3/2 max-pool
    -> int8 requant after the pool. The conv runs in the compute dtype
    and its output is rounded to it BEFORE the f32 bias is added (as
    jax's conv-then-add promotes), then relu and a cast back."""
    cdt = q['conv1']['w'].dtype
    h = cnn.conv2d(q['conv1'], x.to(cdt), stride=2, padding=3)
    h = torch.relu(h).to(cdt)
    return _q8(cnn.max_pool(h, 3, 2, 1))


def _unpack(c):
    return c['w'][0, 0], c['b']


def _apply_trunk_v2(q, cfg, h8):
    """int8 stem output (N, H, W, 64) -> boundary-int8 trunk -> f32 head
    logits. Inter-kernel activations stay in the compute dtype except at
    the stage output and the trunk's last block (int8), as in the JAX
    default routing."""
    assert cfg['block'] == 'bottleneck' and cfg['groups'] == 1, \
        'v2 path targets the resnet50 family'
    blocks = [(li, bi, qb) for li in range(4)
              for bi, qb in enumerate(q[f'layer{li + 1}'])]
    k = 0
    while k < len(blocks):
        li, bi, qb = blocks[k]
        stride = 2 if (li > 0 and bi == 0) else 1
        if 'down' in qb and stride == 1:
            # layer1: the projection block and its identity run, one call
            j = k + 1
            while j < len(blocks) and 'down' not in blocks[j][2]:
                j += 1
            run = [blocks[i][2] for i in range(k + 1, j)]
            down = (*_unpack(qb['conv1']), qb['conv2']['w'],
                    qb['conv2']['b'], *_unpack(qb['conv3']),
                    *_unpack(qb['down']))
            iden = [(*_unpack(b['conv1']), b['conv2']['w'], b['conv2']['b'],
                     *_unpack(b['conv3'])) for b in run]
            h8 = bk.fused_bottleneck_i8v2_stage(
                h8, down, iden, [b['r'] for b in run], out_int8=True)
            k = j
            continue
        out_i8 = k + 1 == len(blocks)
        if 'down' in qb:
            h8 = bk.fused_bottleneck_i8v2_down_s2(
                h8, *_unpack(qb['conv1']), qb['conv2']['w'],
                qb['conv2']['b'], *_unpack(qb['conv3']),
                *_unpack(qb['down']), out_int8=out_i8)
        else:
            h8 = bk.fused_bottleneck_i8v2_identity(
                h8, *_unpack(qb['conv1']), qb['conv2']['w'],
                qb['conv2']['b'], *_unpack(qb['conv3']), qb['r'],
                out_int8=out_i8)
        k += 1
    pooled = (h8.float() * q['s_feat']).mean(dim=(1, 2))
    if cfg['dual_head']:
        return (cnn.linear(q['fc_occ'], pooled),
                cnn.linear(q['fc_depth'], pooled))
    return cnn.linear(q['fc'], pooled)


def apply_folded_v2(q, cfg, x):
    """Prep output (N, H, W, 5) -> boundary-int8 trunk -> f32 logits."""
    return _apply_trunk_v2(q, cfg, _stem_v2(q, x))
