"""The host-side layout decisions of the implicit-GEMM block kernels
(csrc/conv_gemm.cuh, csrc/bottleneck_v2.cu, csrc/bottleneck_int8.cu,
csrc/bottleneck_f32.cu): the CTA's output width, the K step of each
operand type and the K-packed projection's rule on it, the int8
weights' K-major layout and the f32 weights' split K-major layout.
Plain functions, so that the CPU tests reach them.
"""

from __future__ import annotations

import torch

# elements of one K step, 128 bytes of an operand row: bf16 (and int8
# widened to bf16) in the bf16 ring, f32 (and int8, 32 raw bytes
# widened to f32) in the 3xTF32 ring
BF16_K_STEP = 64
F32_K_STEP = 32


def tile_n(cout, two_sums=False):
    """Output columns of one CTA: 128 (a 128 x 128 tile), or 64 where
    Cout is not a multiple of 128 (layer1's conv1 and 3x3, Cout = 64) or
    where the kernel holds two sums (two_sums: the int8 projection keeps
    its finished projection beside the accumulator, and at 64 columns
    both fit the register budget of two CTAs to an SM)."""
    if cout <= 0 or cout % 64:
        raise ValueError(f'output channels must be a multiple of 64, got '
                         f'{cout}')
    return 128 if cout % 128 == 0 and not two_sums else 64


# the f32 (3xTF32) kernel runs its 64-wide tiles two CTAs to an SM and its
# 128-wide tiles one: at a K axis this short (a few K steps) one CTA
# cannot hide its prologue and epilogue behind its MMAs, and two 64-wide
# CTAs are faster (layer1's conv3 and projection, layer2's conv3, on the
# H100); from K = 384 up one 128-wide CTA is faster
F32_SHORT_K = 128


def tile_n_f32(cout, k):
    """Output columns of one CTA of the f32 kernel for a launch whose K
    axis (all segments) is k: `tile_n`'s, or 64 where k <= F32_SHORT_K."""
    bn = tile_n(cout)
    return 64 if k <= F32_SHORT_K else bn


def check_k_steps(ks, step=BF16_K_STEP):
    """K steps per segment of one K-packed launch (segment Ks `ks`, in
    order). A step never straddles two segments: every segment but the
    last must be a whole number of steps (the last one's ragged end is
    zero-filled)."""
    for k in ks[:-1]:
        if k % step:
            raise ValueError(f'a K-packed segment of K = {k} would straddle '
                             f'the next: K must be a multiple of {step}')
    return [-(-k // step) for k in ks]


def kmajor(w):
    """int8 weights as the int8 kernel reads them: an HWIO (kh, kw, Cin,
    Cout) or (Cin, Cout) tensor -> (Cout, K) contiguous, K = kh * kw *
    Cin in the im2col order (tap-major, then channel). int8 wgmma takes
    its B operand only K-major; this runs once, when the model is built
    on the card."""
    if w.dim() not in (2, 4):
        raise ValueError(f'expected (Cin, Cout) or (kh, kw, Cin, Cout) '
                         f'weights, got {tuple(w.shape)}')
    return w.reshape(-1, w.shape[-1]).t().contiguous()


def tf32(w):
    """f32 values rounded to TF32 as the card's cvt.rna.tf32.f32 rounds
    them: 10 mantissa bits, to nearest, ties away from zero, returned as
    f32 with the low 13 mantissa bits 0 (finite inputs)."""
    bits = w.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_kmajor_f32(w):
    """f32 weights as the f32 (3xTF32) kernel reads them: an HWIO (kh,
    kw, Cin, Cout) or (Cin, Cout) tensor -> one contiguous (2, Cout, K)
    f32 tensor [hi, lo], K-major in the im2col order (`kmajor`), with hi
    = tf32(w) and lo = tf32(w - hi) (the subtraction is exact; hi + lo is
    within 2^-22 |w| of w). tf32 wgmma takes both operands only K-major;
    this runs once, when the model is built on the card."""
    if w.dtype != torch.float32:
        raise ValueError(f'expected f32 weights, got {w.dtype}')
    k = kmajor(w)
    hi = tf32(k)
    return torch.stack([hi, tf32(k - hi)]).contiguous()
