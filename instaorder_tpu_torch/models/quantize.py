"""Post-training quantization of the folded ResNet serving trunk
(counterpart of instaorder_tpu/models/quantize.py): the boundary-int8
("v2") path first, the fully quantized int8c path at the end of the file
(`quantize_folded_resnet`, `apply_folded_int8*`, its own notes there).

int8 is only the storage format at block boundaries — the stem output
and every bottleneck output hold integers 0..127 — while all arithmetic
inside a block runs in the compute dtype (`quantize_folded_v2`'s
compute_dtype: bf16 by default, or f32; the kernels take either on the
card). Scale algebra per block with boundary scales s_in / s_out:
  conv1 w *= s_in          (the int8 input feeds the matmul directly)
  conv3 w /= s_out, b /= s_out
  down  w *= s_in / s_out, b /= s_out
  identity residual: + x_int8 * (s_in / s_out)
  output: clip(round(relu(.)), 0, 127) -> int8
The stem folds 1/s_stem into conv1.

`use_pallas` routes blocks to the kernels by the JAX package's feature
names (models/folding.PALLAS_VOCAB; `_apply_trunk_v2` has the rules).
The default set is the JAX default: all of layer1 (the stride-1
projection and its identity run) is one stage call ('hwncs1d'), the
three stride-2 projections go to the stride-2 kernel ('down2') and the
remaining identity blocks to the identity kernel ('hwnc')
(ops/bottleneck_kernels.py), with the cuDNN stem. The 'stem' feature
runs the fused stem kernel with its in-kernel int8 quantisation
(ops/stem_kernels.py, q8); 'stem2' and 'qpool' are cuDNN stem routes.
An explicit set replaces the default, so `('stem',)` is the plain trunk
behind the fused stem and False the plain path throughout.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..core import nn as cnn
from ..ops import bottleneck_kernels as bk
from ..ops import int8_kernels as ik
from ..ops.gemm_layout import kmajor
from ..ops.stem_kernels import (fused_stem, fused_stem_int8,
                                fused_stem_int8_plain)
from .folding import (IDEN_CIN_CAP, _kernel_args, _pallas_features,
                      _stem_fusable, add_stem_kernel_weights, s2d_conv1_w,
                      s2d_stem_input, siamese_forward)

# the v2 default feature set, the JAX default: all of the trunk on the
# kernels, the cuDNN stem. 'dirpack' changes nothing here (see
# apply_folded_v2_siamese).
PALLAS_DEFAULT_V2 = frozenset(('hwnc', 'down2', 'hwncs1d', 'dirpack'))
# the hwnc features; with any of them on, the conv1 Cin cap is
# HWNC_CIN_CAP (every block of ResNet-50), else IDEN_CIN_CAP
HWNC_FEATS = frozenset(('hwnc', 'hwncs', 'hwncs1', 'hwncs1d', 'hwncp'))
HWNC_CIN_CAP = 2048
# H * W * conv1 Cin up to which 'hwncs' fuses an identity run (layers
# 2-4 of ResNet-50 at 256^2 inputs; the JAX package's VMEM limit)
HWNCS_PLANE_CAP = 600_000

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
    """Pre-activation -> one-sided int8 boundary storage. Works in place
    on `y`, a fresh tensor at every caller (one f32 layer1 plane of the
    2x1620-image serving-d2 batch is 13.6 GB)."""
    return y.relu_().round_().clamp_(0, 127).to(torch.int8)


def _v2_features(use_pallas, default=PALLAS_DEFAULT_V2):
    return _pallas_features(use_pallas, default=default)


def _stem_v2(q, x, use_pallas=True):
    """Compute-dtype stem conv (1/s_stem folded) + relu -> 3x3/2 max-pool
    -> int8 requant after the pool. The conv runs in the compute dtype
    and its output is rounded to it BEFORE the f32 bias is added (as
    jax's conv-then-add promotes), then relu and a cast back.

    use_pallas with 'stem': the fused stem kernel with q8 (the bias is
    added in f32 before the one rounding; see ops/stem_kernels.py). It
    wins over 'stem2' (the same conv as a 4x4 stride-1 conv over the 2x2
    space-to-depth input: the same taps, f32 sums in another order) and
    'qpool' (requant before the pool: relu, round, clip and max are
    monotone, so the int8 output is the same; the requantised integers
    are pooled in the compute dtype, where 0..127 are exact, as torch's
    int8 max-pool refuses large channels-last planes)."""
    cdt = q['conv1']['w'].dtype
    feats = _v2_features(use_pallas, default=frozenset())
    w = q['conv1']['w']
    if 'stem' in feats and _stem_fusable(w, x):
        return fused_stem(x.to(cdt).contiguous(), w.contiguous(),
                          q['conv1']['b'], q8=True, wk=q['conv1'].get('wk'))
    if ('stem2' in feats and w.shape[:2] == (7, 7)
            and x.shape[1] % 2 == 0 and x.shape[2] % 2 == 0):
        h = cnn.conv2d({'w': s2d_conv1_w(w), 'b': q['conv1']['b']},
                       s2d_stem_input(x.to(cdt)))
    else:
        h = cnn.conv2d(q['conv1'], x.to(cdt), stride=2, padding=3)
    h = torch.relu(h).to(cdt)
    if 'qpool' in feats:
        return cnn.max_pool(_q8(h).to(cdt), 3, 2, 1).to(torch.int8)
    return _q8(cnn.max_pool(h, 3, 2, 1))


def _plain_block_v2(qb, h8, stride):
    """One v2 block as the plain conv chain (cuDNN on the card; the JAX
    package's XLA route): each conv in the compute dtype, rounded to it
    before the f32 bias is added."""
    cdt = qb['conv1']['w'].dtype
    xb = h8.to(cdt)
    h = torch.relu(cnn.conv2d(qb['conv1'], xb)).to(cdt)
    h = torch.relu(cnn.conv2d(qb['conv2'], h, stride=stride,
                              padding=1)).to(cdt)
    y = cnn.conv2d(qb['conv3'], h)
    if 'down' in qb:
        y.add_(cnn.conv2d(qb['down'], xb, stride=stride))
    else:
        y.add_(xb.to(torch.float32, copy=True).mul_(qb['r']))
    return _q8(y)


def _apply_trunk_v2(q, cfg, h8, use_pallas=True):
    """int8 stem output (N, H, W, 64) -> boundary-int8 trunk -> f32 head
    logits, routed by the features as the JAX package's `_apply_trunk_v2`
    routes them. A block may take a kernel when its conv1 Cin is within
    the cap (HWNC_CIN_CAP with an hwnc feature on, else IDEN_CIN_CAP)
    and, for a stride-2 projection, 'down2' is on; for the stride-1
    projection 'down1', 'hwncs1d' or 'hwncp'; for an identity block
    'identity' or an hwnc feature. Such blocks go, with an hwnc feature
    on, to:
      the stride-1 projection and its identity run: one stage call
        ('hwncp' -> fused_bottleneck_i8v2_hwncp_stage, else 'hwncs1d' ->
        fused_bottleneck_i8v2_stage), else the projection alone
        (fused_bottleneck_down_i8v2_hwnc);
      an identity run: one fused_bottleneck_i8v2_stage(down=None) call
        where 'hwncs' is on and H * W * Cin <= HWNCS_PLANE_CAP, or where
        'hwncs1' is on in layer1; else one fused_bottleneck_i8v2_identity
        call per block;
    and without one, the stride-1 projection to fused_bottleneck_down_i8v2
    and identity blocks to fused_bottleneck_i8v2. Stride-2 projections go
    to fused_bottleneck_i8v2_down_s2; every other block is the plain
    chain. Between two kernels the activation stays in the compute dtype
    (the same integers); it is int8 at a stage's output, before a plain
    block and at the trunk's end. The JAX package's pad-to-8 and hwnc
    transposes are TPU layout devices and do not carry over."""
    assert cfg['block'] == 'bottleneck' and cfg['groups'] == 1, \
        'v2 path targets the resnet50 family'
    feats = _v2_features(use_pallas)
    hwnc_on = bool(feats & HWNC_FEATS)
    cap = HWNC_CIN_CAP if hwnc_on else IDEN_CIN_CAP
    blocks = [(li, bi, qb) for li in range(4)
              for bi, qb in enumerate(q[f'layer{li + 1}'])]

    def kernel_ok(li, bi, qb):
        if qb['conv1']['w'].shape[2] > cap:
            return False
        if li > 0 and bi == 0:
            return 'down2' in feats
        if 'down' in qb:
            return bool(feats & {'down1', 'hwncs1d', 'hwncp'})
        return bool(feats & (HWNC_FEATS | {'identity'}))

    ok = [kernel_ok(*b) for b in blocks] + [False]

    def run_end(j):
        """The end of the identity run of kernel blocks from j."""
        while ok[j] and 'down' not in blocks[j][2]:
            j += 1
        return j

    def run_args(i, j):
        run = [blocks[t][2] for t in range(i, j)]
        return [_kernel_args(b) for b in run], [b['r'] for b in run]

    def run_wk(i, j):
        return [blocks[t][2].get('wk') for t in range(i, j)]

    k = 0
    while k < len(blocks):
        li, bi, qb = blocks[k]
        stride = 2 if (li > 0 and bi == 0) else 1
        out_i8 = not ok[k + 1]
        a = _kernel_args(qb)
        wk = qb.get('wk')
        j = k + 1
        if not ok[k]:
            h8 = _plain_block_v2(qb, h8, stride)
        elif stride == 2:
            h8 = bk.fused_bottleneck_i8v2_down_s2(h8, *a, out_int8=out_i8,
                                                  wk=wk)
        elif 'down' in qb and hwnc_on:
            j = run_end(k + 1)
            if j > k + 1 and feats & {'hwncs1d', 'hwncp'}:
                fn = (bk.fused_bottleneck_i8v2_hwncp_stage if 'hwncp' in feats
                      else bk.fused_bottleneck_i8v2_stage)
                h8 = fn(h8, a, *run_args(k + 1, j), out_int8=True,
                        wk=run_wk(k, j))
            else:
                j = k + 1
                h8 = bk.fused_bottleneck_down_i8v2_hwnc(
                    h8, *a, out_int8=out_i8 or 'hwncs1' in feats, wk=wk)
        elif hwnc_on:
            plane = h8.shape[1] * h8.shape[2] * qb['conv1']['w'].shape[2]
            if (('hwncs' in feats and plane <= HWNCS_PLANE_CAP)
                    or ('hwncs1' in feats and li == 0)):
                j = run_end(k)
                h8 = bk.fused_bottleneck_i8v2_stage(
                    h8, None, *run_args(k, j), out_int8=li == 0 or not ok[j],
                    wk=run_wk(k, j))
            else:
                h8 = bk.fused_bottleneck_i8v2_identity(h8, *a, qb['r'],
                                                       out_int8=out_i8, wk=wk)
        elif 'down' in qb:
            h8 = bk.fused_bottleneck_down_i8v2(h8, *a, out_int8=out_i8, wk=wk)
        else:
            h8 = bk.fused_bottleneck_i8v2(h8, *a, qb['r'], out_int8=out_i8,
                                          wk=wk)
        k = j
    pooled = (h8.float() * q['s_feat']).mean(dim=(1, 2))
    if cfg['dual_head']:
        return (cnn.linear(q['fc_occ'], pooled),
                cnn.linear(q['fc_depth'], pooled))
    return cnn.linear(q['fc'], pooled)


def apply_folded_v2(q, cfg, x, use_pallas=True):
    """Prep output (N, H, W, 5) -> boundary-int8 trunk -> f32 logits."""
    return _apply_trunk_v2(q, cfg, _stem_v2(q, x, use_pallas=use_pallas),
                           use_pallas=use_pallas)


def apply_folded_v2_siamese(q, cfg, x, use_pallas=True):
    """Both swap directions via the swapped conv1 (models/folding
    `siamese_forward`): one double-width stem over x, one trunk call on
    the 2N batch [direction 0; direction 1]. (The JAX package's
    `dirpack` interleave is a TPU layout device; the trunk is per-image,
    so the batch order changes nothing and the feature is accepted as a
    no-op.) Returns (out1, out2)."""
    return siamese_forward(
        q['conv1'], x,
        lambda c1, x: _stem_v2(dict(q, conv1=c1), x, use_pallas=use_pallas),
        lambda h8: _apply_trunk_v2(q, cfg, h8, use_pallas=use_pallas))


# ---------------------------------------------------------------------------
# int8c: the fully quantized path (the JAX package's round-2 scheme,
# `quantize_folded_resnet` / `apply_folded_int8*`). Every conv is s8 x s8
# -> s32 and every activation int8, h1 and h2 included; each conv's
# epilogue folds m = s_in * s_w / s_out per output channel and b =
# bias / s_out:
#   rq8(acc) = clip(round(f32(acc) * m + b), 0, 127)
# The residual adds f32(x) * sxr (sxr = s_x / s_out) or the projection's
# own (accd * md + bd) before the round. s32 sums are exact, so the path
# equals the JAX package bit for bit up to the f32 head.
# ---------------------------------------------------------------------------

# the int8c default feature set (the JAX default). The path routes
# 'identity', 'down', 'stem' and 'hwnc' and ignores the vocabulary's
# other names: 'hwnc' sends the identity blocks, and with 'down' the
# projections, to the kernels named after the JAX hwnc kernels; the port
# has no hwnc view, so they launch the NHWC kernel (ops/int8_kernels.py).
PALLAS_DEFAULT_INT8 = frozenset(('identity', 'down'))


def _int8_features(use_pallas):
    return _pallas_features(use_pallas, default=PALLAS_DEFAULT_INT8)


def _quant_w(w):
    """HWIO weight -> (int8 weight, per-out-channel f32 scale)."""
    w = w.float()
    s = (w.abs().reshape(-1, w.shape[-1]).amax(dim=0) / 127.0).clamp_min(
        1e-8)
    return torch.round(w / s).clamp_(-127, 127).to(torch.int8).contiguous(), s


def _qconv(p, s_in, s_out):
    w8, sw = _quant_w(p['w'])
    return {'w': w8, 'm': (s_in * sw / s_out).contiguous(),
            'b': (p['b'].float() / s_out).contiguous()}


def quantize_folded_resnet(folded, cfg, scales):
    """folded f32 params + calibration scales -> int8c serving params:
    int8 HWIO weights with f32 per-channel `m`, `b` for every conv, the
    Python-float scalars `sxr` (identity blocks), `s_out`, `s_feat`, and
    `cfg_scales` {'in', 'stem'} (the key that tells an int8c tree from a
    v2 one)."""
    s_in, s_stem = float(scales['in']), float(scales['stem'])
    q: Dict[str, Any] = {'cfg_scales': {'in': s_in, 'stem': s_stem},
                         'conv1': _qconv(folded['conv1'], s_in, s_stem)}
    s_prev = s_stem
    for li in range(4):
        name = f'layer{li + 1}'
        stage = []
        for bi, bp in enumerate(folded[name]):
            sc = scales[name][bi]
            s_h1, s_h2, s_out = (float(sc['h1']), float(sc['h2']),
                                 float(sc['out']))
            qb: Dict[str, Any] = {
                'conv1': _qconv(bp['conv1'], s_prev, s_h1),
                'conv2': _qconv(bp['conv2'], s_h1, s_h2),
                'conv3': _qconv(bp['conv3'], s_h2, s_out)}
            if 'down' in bp:
                # the projection feeds the residual add in conv3's output
                # scale domain
                qb['down'] = _qconv(bp['down'], s_prev, s_out)
            else:
                qb['sxr'] = float(np.float32(s_prev / s_out))
            qb['s_out'] = float(np.float32(s_out))
            stage.append(qb)
            s_prev = s_out
        q[name] = stage
    for fc in ('fc', 'fc_occ', 'fc_depth'):
        if fc in folded:
            q[fc] = {k: v.float() for k, v in folded[fc].items()}
    q['s_feat'] = float(np.float32(s_prev))
    return q


def quantize_input(x, s_in):
    """Prep output -> int8 input: clip(round(f32(x) / s_in), -127, 127)."""
    return torch.round(x.float() / s_in).clamp_(-127, 127).to(torch.int8)


def _stem_int8(q, x8, use_pallas=False):
    """int8 stem: the fused kernel with 'stem' (ops/stem_kernels
    `fused_stem_int8`), else the plain s32 conv, requant and int8 pool."""
    c1 = q['conv1']
    if ('stem' in _int8_features(use_pallas)
            and _stem_fusable(c1['w'], x8)):
        return fused_stem_int8(x8.contiguous(), c1['w'], c1['m'], c1['b'],
                               wk=c1.get('wk'))
    return fused_stem_int8_plain(x8, c1['w'], c1['m'], c1['b'])


def _int8_args(qb):
    """A block's convs as the int8 kernels take them: (w1, m1, b1, w2,
    m2, b2, w3, m3, b3), 1x1 weights as (Cin, Cout) matrices, then (wd,
    md, bd) where the block has a projection."""
    args = []
    for c in ('conv1', 'conv2', 'conv3', 'down'):
        if c in qb:
            w = qb[c]['w']
            args += [w if c == 'conv2' else w[0, 0], qb[c]['m'], qb[c]['b']]
    return args


def add_kernel_weights(q):
    """Give every block of the int8c tree `q` its K-major weights
    (`wk`: the (Cout, K) copies of w1, w2, w3 and wd that the card's
    int8 kernel reads, ops/gemm_layout.kmajor) and its conv1 the stem
    kernel's weights (models/folding `add_stem_kernel_weights`), once,
    when the model is built on the card. The JAX-layout weights stay
    beside them for the plain versions. Returns q."""
    add_stem_kernel_weights(q['conv1'])
    for li in range(4):
        for qb in q[f'layer{li + 1}']:
            qb['wk'] = [kmajor(qb[c]['w'])
                        for c in ('conv1', 'conv2', 'conv3', 'down')
                        if c in qb]
    return q


def _plain_block_int8(qb, h8, stride):
    """One int8c block as the plain conv chain (the XLA int8 oracle)."""
    if 'down' in qb:
        return ik.fused_bottleneck_down_int8_plain(h8, *_int8_args(qb),
                                                   stride=stride)
    return ik.fused_bottleneck_int8_plain(h8, *_int8_args(qb), qb['sxr'])


def _trunk_int8(q, cfg, h8, use_pallas=True):
    """int8 stem output -> int8 trunk output, routed as the JAX package's
    `_apply_trunk_int8`: with 'hwnc' every stride-1 identity block goes
    to `fused_bottleneck_int8_hwnc` and, with 'down' too, the projections
    to `fused_bottleneck_down_int8_hwnc` (stride 1) and
    `fused_bottleneck_down_s2_int8_hwnc` (stride 2); otherwise 'identity'
    sends identity blocks to `fused_bottleneck_int8` and 'down' the
    projections to `fused_bottleneck_down_int8`; every other block runs
    the plain chain. No conv1 Cin cap (unlike v2). The JAX package's
    pad-to-8 and hwnc transposes are TPU layout devices and do not carry
    over."""
    assert cfg['block'] == 'bottleneck' and cfg['groups'] == 1, \
        'int8c path targets the resnet50 family'
    feats = _int8_features(use_pallas)
    for li in range(4):
        for bi, qb in enumerate(q[f'layer{li + 1}']):
            stride = 2 if (li > 0 and bi == 0) else 1
            a = _int8_args(qb)
            wk = qb.get('wk')
            down = 'down' in qb
            if not down and stride == 1 and 'hwnc' in feats:
                h8 = ik.fused_bottleneck_int8_hwnc(h8, *a, qb['sxr'], wk=wk)
            elif down and {'hwnc', 'down'} <= feats:
                fn = (ik.fused_bottleneck_down_s2_int8_hwnc if stride == 2
                      else ik.fused_bottleneck_down_int8_hwnc)
                h8 = fn(h8, *a, wk=wk)
            elif not down and stride == 1 and 'identity' in feats:
                h8 = ik.fused_bottleneck_int8(h8, *a, qb['sxr'], wk=wk)
            elif down and 'down' in feats:
                h8 = ik.fused_bottleneck_down_int8(h8, *a, stride=stride,
                                                   wk=wk)
            else:
                h8 = _plain_block_int8(qb, h8, stride)
    return h8


def _head_int8(q, cfg, h8):
    """f32 head: h8 * s_feat, mean-pool, fc (dual head where configured)."""
    pooled = (h8.float() * q['s_feat']).mean(dim=(1, 2))
    if cfg['dual_head']:
        return (cnn.linear(q['fc_occ'], pooled),
                cnn.linear(q['fc_depth'], pooled))
    return cnn.linear(q['fc'], pooled)


def _apply_trunk_int8(q, cfg, h8, use_pallas=True):
    return _head_int8(q, cfg, _trunk_int8(q, cfg, h8, use_pallas=use_pallas))


def apply_folded_int8(q, cfg, x, use_pallas=True):
    """Prep output (N, H, W, 5) -> int8 input -> int8c stem and trunk ->
    f32 logits."""
    x8 = quantize_input(x, q['cfg_scales']['in'])
    return _apply_trunk_int8(q, cfg, _stem_int8(q, x8, use_pallas=use_pallas),
                             use_pallas=use_pallas)


def apply_folded_int8_siamese(q, cfg, x, use_pallas=True):
    """Both swap directions (models/folding `siamese_forward`): the input
    quantised once, one double-width stem whose per-channel `m` and `b`
    are concatenated like its weights, one trunk call on the 2N batch.
    Returns (out1, out2)."""
    x8 = quantize_input(x, q['cfg_scales']['in'])
    return siamese_forward(
        q['conv1'], x8,
        lambda c1, x8: _stem_int8(dict(q, conv1=c1), x8,
                                  use_pallas=use_pallas),
        lambda h8: _apply_trunk_int8(q, cfg, h8, use_pallas=use_pallas))
