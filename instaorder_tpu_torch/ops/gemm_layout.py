"""The host-side layout decisions of the implicit-GEMM block kernels
(csrc/conv_gemm.cuh, csrc/bottleneck_v2.cu, csrc/bottleneck_int8.cu,
csrc/bottleneck_f32.cu): the CTA's output width, the K step of each
operand type and the K-packed projection's rule on it, and the int8
weights' K-major layout. Plain functions, so that the CPU tests reach
them.
"""

from __future__ import annotations

import torch

# elements of one K step, 128 bytes of an operand row: bf16 (and int8
# widened to bf16) in the wgmma ring, f32 (and int8, 32 raw bytes
# widened to f32) in the CUDA-core ring
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
