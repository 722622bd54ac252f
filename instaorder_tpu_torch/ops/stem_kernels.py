"""Kernels 15 and 18: the fused ResNet stem, bf16/q8 and int8c
(csrc/stem.cu).

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
stem (Cout 128; see csrc/stem.cu). Design: one CTA per (image, 8x8 tile
of pooled outputs), the input window and the weights staged in shared
memory, the conv as an implicit GEMM on the tensor cores (K = 7*7*C
padded to 256, so C <= 5), bias + relu + bf16 into a shared conv tile,
then the pool.

On CPU tensors the wrapper runs `fused_stem_plain`; on CUDA tensors it
launches the kernel or raises, and adds one to `fused_stem.launches`
per call. The card takes bf16 x and w and an f32 bias (f32 compute on
the card is not ported: ROADMAP.md queue 2, "f32 on the card").
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from .int8_kernels import batch_chunks, conv_int8, requant


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


def fused_stem(x, w, b, q8=False):
    """Fused stem. x (N, H, W, C) with C <= 5; w (7, 7, C, Cout), Cout 64
    or 128 (the double-width siamese stem); b (Cout,) f32 on the card.
    -> (N, ceil(H/4), ceil(W/4), Cout) in x.dtype, or int8 with q8."""
    if x.device.type == 'cpu':
        return fused_stem_plain(x, w, b, q8=q8)
    dev = x.device
    if x.dtype != torch.bfloat16:
        raise ValueError(
            f'fused_stem: x is {x.dtype}; the card takes bf16 activations '
            '(f32 compute on the card is not ported: ROADMAP.md queue 2, '
            '"f32 on the card")')
    N, H, W, C = x.shape
    cout = w.shape[-1]
    if tuple(w.shape) != (7, 7, C, cout) or C > 5 or cout not in (64, 128):
        raise ValueError(f'fused_stem: w must be (7, 7, C<=5, 64|128) for x '
                         f'{tuple(x.shape)}, got {tuple(w.shape)}')
    if (w.dtype != torch.bfloat16 or w.device != dev
            or not w.is_contiguous() or w.data_ptr() % 16):
        raise ValueError(f'fused_stem: w must be contiguous bf16 on {dev}')
    if (b.dtype != torch.float32 or b.device != dev
            or tuple(b.shape) != (cout,) or not b.is_contiguous()):
        raise ValueError(f'fused_stem: bias must be a contiguous ({cout},) '
                         f'f32 tensor on {dev}')
    if not x.is_contiguous():
        raise ValueError('fused_stem: x must be contiguous')
    Hc, Wc = (H - 1) // 2 + 1, (W - 1) // 2 + 1
    out = torch.empty((N, (Hc - 1) // 2 + 1, (Wc - 1) // 2 + 1, cout),
                      dtype=torch.int8 if q8 else torch.bfloat16,
                      device=dev)
    rc = _build.library().io_fused_stem(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), N, H, W,
        C, cout, int(bool(q8)), torch.cuda.current_stream(dev).cuda_stream)
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
# double-width stem; the design is the bf16 kernel's with s8 WMMA and an
# int8 conv tile (the weight tile is 32 KB at Cout 128).
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


def fused_stem_int8(x8, w8, m, b):
    """Fused int8c stem. x8 (N, H, W, C) int8 with C <= 5; w8 (7, 7, C,
    Cout) int8, Cout 64 or 128; m, b (Cout,) f32. -> (N, ceil(H/4),
    ceil(W/4), Cout) int8."""
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
    if (w8.dtype != torch.int8 or w8.device != dev
            or not w8.is_contiguous() or w8.data_ptr() % 16):
        raise ValueError(f'fused_stem_int8: w must be contiguous int8 on '
                         f'{dev}')
    for t, name in ((m, 'multiplier'), (b, 'bias')):
        if (t.dtype != torch.float32 or t.device != dev
                or tuple(t.shape) != (cout,) or not t.is_contiguous()):
            raise ValueError(f'fused_stem_int8: {name} must be a contiguous '
                             f'({cout},) f32 tensor on {dev}')
    Hc, Wc = (H - 1) // 2 + 1, (W - 1) // 2 + 1
    out = torch.empty((N, (Hc - 1) // 2 + 1, (Wc - 1) // 2 + 1, cout),
                      dtype=torch.int8, device=dev)
    rc = _build.library().io_fused_stem_s8(
        x8.data_ptr(), w8.data_ptr(), m.data_ptr(), b.data_ptr(),
        out.data_ptr(), N, H, W, C, cout,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, 'fused_stem_int8')
    fused_stem_int8.launches += 1
    return out


fused_stem_int8.launches = 0
