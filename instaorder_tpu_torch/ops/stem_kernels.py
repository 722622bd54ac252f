"""Kernels 15 and 18: the fused ResNet stem, bf16 and f32 (each also q8)
and int8c (csrc/stem.cu).

Replaces instaorder_tpu/ops/pallas_blocks.py `fused_stem` (kernel body
`_stem_v2_kernel`, with its `q8` option): conv 7x7 / stride 2 / pad 3,
the bias added in f32, relu, one rounding to x.dtype, max-pool 3x3 /
stride 2 / pad 1, stored in x.dtype or (q8) as the one-sided int8
clip(rint(v), 0, 127) of the v2 boundary. The (N, H/2, W/2, Cout) conv
output never reaches device memory.

This is `fused_stem`'s contract, not the unfused stem's: the cuDNN / XLA
stem of the v2 path (models/quantize._stem_v2) rounds the conv to bf16
BEFORE its f32 bias add, the fused stem after it.

Bound on the H100: tensor-core operations at the double-width siamese
stem (Cout 128; see csrc/stem.cu). Design: the 7x7/2 conv as a 4x4
stride-1 conv over the 2x2 space-to-depth input, which a pack pass
writes chunk-planar with its 4C channels padded to 16-byte chunks
(`stem_pack_plain`); the kernel copies s2d rows into shared memory with
16-byte cp.async and runs wgmma on them in place, with the weights in
the matching order (`stem_kernel_weights`, laid out once when the model
is built on the card), and pools in its epilogue.

The f32 mode (`fused_stem` given f32 x and w, which the TPU kernel
computes in f32): bound by tensor-core operations at three TF32 products
per f32 product (3xTF32, as the f32 block kernel: one TF32 product would
miss the f32 bar, three keep ~22 bits). The same s2d design: the pack
writes the s2d input with its 4C f32 channels as exactly C chunks; the
kernel reads A's hi in place (tf32 wgmma reads the top 19 bits of an
f32, so hi = trunc(a)) and forms lo = tf32(a - hi) in registers, against
split K-major weights (`stem_kernel_weights` at f32) that skip the k8
steps whose weights are all zero (`f32_stem_steps`), 64 output channels
a CTA, each K step's products in a fresh accumulator, the pool in the
epilogue; nothing is rounded below f32. With q8 (the v2 model's stem at
compute_dtype=f32) it stores the pooled values as the one-sided int8
clip(rint(v), 0, 127), quantised after the pool.

On CPU tensors the wrappers run the plain versions; on CUDA tensors they
launch the kernel (and its pack) or raise, and add one to
`launches` per call. The card takes bf16 x and w, or f32 ones, and an
f32 bias.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import _build
from .gemm_layout import split_kmajor_f32
from .int8_kernels import batch_chunks, conv_int8, requant


def s2d_conv1_w(w):
    """The 7x7/stride-2 stem conv as a 4x4 stride-1 conv over the 2x2
    space-to-depth input ('stem2'; the same taps): w2[du, dxu, (sy, sx,
    c)] = w[2du+sy-1, 2dxu+sx-1, c], zero where the index leaves 0..6."""
    C, Co = w.shape[2], w.shape[3]
    wp = torch.nn.functional.pad(w, (0, 0, 0, 0, 1, 0, 1, 0))
    w2 = wp.reshape(4, 2, 4, 2, C, Co).permute(0, 2, 1, 3, 4, 5)
    return w2.reshape(4, 4, 4 * C, Co).contiguous()


def s2d_stem_input(x):
    """Pad (4, 2) x (4, 2) and 2x2 space-to-depth: (N, H, W, C) ->
    (N, H/2 + 3, W/2 + 3, 4C), channel order (sy, sx, c) to match
    s2d_conv1_w. Requires even H, W."""
    n, H, W, C = x.shape
    assert H % 2 == 0 and W % 2 == 0, (H, W)
    xp = torch.nn.functional.pad(x, (0, 0, 4, 2, 4, 2))
    x2 = xp.reshape(n, (H + 6) // 2, 2, (W + 6) // 2, 2, C)
    return x2.permute(0, 1, 3, 2, 4, 5).reshape(
        n, (H + 6) // 2, (W + 6) // 2, 4 * C)


def stem_chunks(dtype, c):
    """(J, CW): the 16-byte chunks of a padded s2d pixel of 4c channels
    and the elements of a chunk, (3, 8) for bf16 (24 channels), (2, 16)
    for int8 (32), (c, 4) for f32 (exactly 4c)."""
    if dtype == torch.float32:
        return c, 4
    return (2, 16) if dtype == torch.int8 else (3, 8)


def f32_stem_steps(c):
    """The k8 steps of the f32 stem kernel's K axis in its order: (du,
    dxp, j) for tap row du, tap column pair dxp (taps 2 dxp and 2 dxp +
    1) and chunk j (s2d channels 4j .. 4j + 3), without the du = 0 chunks
    whose channels all have sy = 0, i.e. read the pad row above tap row
    0 (j < c // 2): their weights are zero. 8c - 2 (c // 2) steps of 8,
    K = 288 at c = 5."""
    return [(du, dxp, j) for du in range(4) for dxp in range(2)
            for j in range(c) if du or j >= c // 2]


def stem_pack_plain(x):
    """The input the stem kernel reads (csrc/stem.cu `stem_pack_kernel`):
    s2d_stem_input with its 4C channels zero-padded to J * CW, chunk-
    planar: (N, H/2 + 3, J, W/2 + 3, CW)."""
    J, cw = stem_chunks(x.dtype, x.shape[-1])
    xs = s2d_stem_input(x)
    n, hs, ws, c4 = xs.shape
    xs = F.pad(xs, (0, J * cw - c4))
    return xs.reshape(n, hs, ws, J, cw).permute(0, 1, 3, 2, 4).contiguous()


def _wk_shape(w):
    """The shape of stem_kernel_weights(w)."""
    if w.dtype == torch.float32:
        return (2, w.shape[-1], 8 * len(f32_stem_steps(w.shape[2])))
    k = int(16 * np.prod(stem_chunks(w.dtype, w.shape[2])))
    return (w.shape[-1], k) if w.dtype == torch.int8 else (k, w.shape[-1])


def stem_kernel_weights(w):
    """HWIO stem weights (7, 7, C <= 5, Cout) -> the layout the card's
    stem kernel reads: the s2d weights (s2d_conv1_w) with their channels
    zero-padded to J * CW, rows in the kernel's K order k = (((du * 2 +
    dxp) * J + j) * 2 + e) * CW + i for tap (du, 2 dxp + e) and padded
    channel j * CW + i. bf16: (K, Cout), K = 384, read MN-major; int8:
    (Cout, K), K = 512, since int8 wgmma reads B only K-major. f32: CW =
    4 and J = C, the k8 steps (du, dxp, j) of `f32_stem_steps` (the zero
    ones left out), each in (e, i) order, split and K-major as tf32 wgmma
    reads them: one (2, Cout, K) tensor [hi, lo], hi = tf32(w), lo =
    tf32(w - hi) (gemm_layout.split_kmajor_f32), K = 288 at C = 5. Built
    once, when the model is built on the card (models/folding
    `add_stem_kernel_weights`)."""
    if w.dtype == torch.float32:
        c, co = w.shape[2], w.shape[3]
        # (du, dxp, e, j, i, co) -> (du, dxp, j, e, i, co)
        w2 = s2d_conv1_w(w).reshape(4, 2, 2, c, 4, co).permute(
            0, 1, 3, 2, 4, 5)
        rows = torch.stack([w2[du, dxp, j]
                            for du, dxp, j in f32_stem_steps(c)])
        return split_kmajor_f32(rows.reshape(-1, co))
    J, cw = stem_chunks(w.dtype, w.shape[2])
    co = w.shape[-1]
    w2 = s2d_conv1_w(w)
    w2 = F.pad(w2, (0, 0, 0, J * cw - w2.shape[2]))
    w2 = w2.reshape(4, 2, 2, J, cw, co).permute(0, 1, 3, 2, 4, 5)
    w2 = w2.reshape(16 * J * cw, co)
    return (w2.t() if w.dtype == torch.int8 else w2).contiguous()


def _check_wk(wk, w, dev, what):
    shape = _wk_shape(w)
    if wk is None:
        raise ValueError(f'{what}: the card needs the stem\'s kernel weights '
                         '(wk=, stem_kernel_weights(w)), laid out once when '
                         'the model is built on the card')
    if (tuple(wk.shape) != shape or wk.dtype != w.dtype or wk.device != dev
            or not wk.is_contiguous() or wk.data_ptr() % 16):
        raise ValueError(f'{what}: wk must be the contiguous {shape} '
                         f'{w.dtype} tensor of stem_kernel_weights on {dev}, '
                         f'got {tuple(wk.shape)} {wk.dtype} on {wk.device}')


def _check_hw(x, what):
    _, H, W, _ = x.shape
    if H < 2 or W < 2 or H % 2 or W % 2:
        raise ValueError(f'{what}: the card takes even H, W >= 2, got '
                         f'{tuple(x.shape)}')
    # the pack reads two elements at a time
    if x.data_ptr() % (2 * x.element_size()):
        raise ValueError(f'{what}: x must be {2 * x.element_size()}-byte '
                         'aligned')


def _pack_scratch(x):
    n, H, W, c = x.shape
    J, _ = stem_chunks(x.dtype, c)
    return torch.empty((n, H // 2 + 3, J, W // 2 + 3, 16), dtype=torch.uint8,
                       device=x.device)


def fused_stem_plain(x, w, b, q8=False):
    """x (N, H, W, C); w (7, 7, C, Cout) HWIO; b (Cout,) -> (N, Ho, Wo,
    Cout) in x.dtype, or int8 with q8 (f32 sums over x.dtype operands)."""
    cdt = x.dtype
    h = F.conv2d(x.float().permute(0, 3, 1, 2),
                 w.to(cdt).float().permute(3, 2, 0, 1), stride=2, padding=3)
    h = torch.relu(h + b.float()[:, None, None]).to(cdt)
    # zero padding is exact for the pool: the values are >= 0 and every
    # window holds a real pixel
    pooled = F.max_pool2d(h.float(), 3, 2, 1).permute(0, 2, 3, 1)
    if q8:
        return torch.clamp(torch.round(pooled), 0, 127).to(torch.int8)
    return pooled.to(cdt)


def fused_stem(x, w, b, q8=False, wk=None):
    """Fused stem. x (N, H, W, C) with C <= 5; w (7, 7, C, Cout), Cout 64
    or 128 (the double-width siamese stem); b (Cout,) f32 on the card;
    wk: stem_kernel_weights(w), which the card needs (the CPU ignores it).
    -> (N, ceil(H/4), ceil(W/4), Cout) in x.dtype, or int8 with q8. The
    card takes bf16 or f32 x with even H, W; either with q8."""
    if x.device.type == 'cpu':
        return fused_stem_plain(x, w, b, q8=q8)
    dev = x.device
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f'fused_stem: x is {x.dtype}; the card takes bf16 '
                         'or f32 activations')
    N, H, W, C = x.shape
    cout = w.shape[-1]
    if tuple(w.shape) != (7, 7, C, cout) or C > 5 or cout not in (64, 128):
        raise ValueError(f'fused_stem: w must be (7, 7, C<=5, 64|128) for x '
                         f'{tuple(x.shape)}, got {tuple(w.shape)}')
    if w.dtype != x.dtype or w.device != dev:
        raise ValueError(f'fused_stem: w must be {str(x.dtype)[6:]} on {dev}')
    if (b.dtype != torch.float32 or b.device != dev
            or tuple(b.shape) != (cout,) or not b.is_contiguous()):
        raise ValueError(f'fused_stem: bias must be a contiguous ({cout},) '
                         f'f32 tensor on {dev}')
    if not x.is_contiguous():
        raise ValueError('fused_stem: x must be contiguous')
    _check_wk(wk, w, dev, 'fused_stem')
    _check_hw(x, 'fused_stem')
    Hc, Wc = H // 2, W // 2
    out = torch.empty((N, (Hc - 1) // 2 + 1, (Wc - 1) // 2 + 1, cout),
                      dtype=torch.int8 if q8 else x.dtype, device=dev)
    entry = 'io_fused_stem_f32' if x.dtype == torch.float32 \
        else 'io_fused_stem'
    rc = _build.launch(entry, dev, x.data_ptr(), _pack_scratch(x).data_ptr(),
                       wk.data_ptr(), b.data_ptr(), out.data_ptr(), N, H, W,
                       C, cout, int(bool(q8)))
    _build.check(rc, 'fused_stem')
    fused_stem.launches += 1
    return out


fused_stem.launches = 0


# ---------------------------------------------------------------------------
# Kernel 18: the int8c stem (csrc/stem.cu `stem_s8_kernel`), replacing
# pallas_blocks.py `fused_stem_int8` (kernel body `_stem_v2_int8_kernel`):
# s8 conv 7x7 / stride 2 / pad 3 with s32 accumulation, the requant
# rq8(acc) = clip(round(f32(acc) * m + b), 0, 127), max-pool 3x3 / stride
# 2 / pad 1 on int8. Bound on the H100: int8 tensor-core operations at the
# double-width stem; the design is the bf16 kernel's on int8 wgmma, with
# (Cout, 512) K-major weights (64 KB at Cout 128).
# ---------------------------------------------------------------------------


def fused_stem_int8_plain(x8, w8, m, b):
    """x8 (N, H, W, C) int8; w8 (7, 7, C, Cout) int8 HWIO; m, b (Cout,)
    f32 -> (N, Ho, Wo, Cout) int8: the exact s32 conv, the requant, then
    the max-pool (its -inf padding equals the reference's -128 on int8).
    The batch is split so that the float64 conv output of a chunk stays
    near 4 GB (1,620 double-width images would need 27 GB at once)."""
    _, H, W, _ = x8.shape
    per_image = ((H + 1) // 2) * ((W + 1) // 2) * w8.shape[-1] * 8
    outs = []
    for xc in batch_chunks(x8, per_image):
        h = requant(conv_int8(xc, w8, 2, 3), m, b)
        # int8 values 0..127 are exact in f32, and max-pool only compares
        pooled = F.max_pool2d(h.permute(0, 3, 1, 2).float(), 3, 2, 1)
        outs.append(pooled.permute(0, 2, 3, 1).to(torch.int8).contiguous())
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def fused_stem_int8(x8, w8, m, b, wk=None):
    """Fused int8c stem. x8 (N, H, W, C) int8 with C <= 5; w8 (7, 7, C,
    Cout) int8, Cout 64 or 128; m, b (Cout,) f32; wk:
    stem_kernel_weights(w8), which the card needs (the CPU ignores it).
    -> (N, ceil(H/4), ceil(W/4), Cout) int8. The card takes even H, W."""
    if x8.device.type == 'cpu':
        return fused_stem_int8_plain(x8, w8, m, b)
    dev = x8.device
    if x8.dtype != torch.int8 or x8.dim() != 4 or not x8.is_contiguous():
        raise ValueError(f'fused_stem_int8: x must be a contiguous (N, H, W, '
                         f'C) int8 tensor, got {tuple(x8.shape)} {x8.dtype}')
    N, H, W, C = x8.shape
    cout = w8.shape[-1]
    if tuple(w8.shape) != (7, 7, C, cout) or C > 5 or cout not in (64, 128):
        raise ValueError(f'fused_stem_int8: w must be (7, 7, C<=5, 64|128) '
                         f'for x {tuple(x8.shape)}, got {tuple(w8.shape)}')
    if w8.dtype != torch.int8 or w8.device != dev:
        raise ValueError(f'fused_stem_int8: w must be int8 on {dev}')
    for t, name in ((m, 'multiplier'), (b, 'bias')):
        if (t.dtype != torch.float32 or t.device != dev
                or tuple(t.shape) != (cout,) or not t.is_contiguous()):
            raise ValueError(f'fused_stem_int8: {name} must be a contiguous '
                             f'({cout},) f32 tensor on {dev}')
    _check_hw(x8, 'fused_stem_int8')
    _check_wk(wk, w8, dev, 'fused_stem_int8')
    Hc, Wc = H // 2, W // 2
    out = torch.empty((N, (Hc - 1) // 2 + 1, (Wc - 1) // 2 + 1, cout),
                      dtype=torch.int8, device=dev)
    rc = _build.launch(
        'io_fused_stem_s8', dev, x8.data_ptr(), _pack_scratch(x8).data_ptr(),
        wk.data_ptr(), m.data_ptr(), b.data_ptr(), out.data_ptr(), N, H, W,
        C, cout)
    _build.check(rc, 'fused_stem_int8')
    fused_stem_int8.launches += 1
    return out


fused_stem_int8.launches = 0
