"""Kernel 15: the fused ResNet stem (csrc/stem.cu).

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
