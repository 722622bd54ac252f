"""OpenCV's bicubic kernel (counterpart of instaorder_tpu/ops/resize.py
`_cubic_kernel`): the same f32 expressions, evaluated left to right, so
the prep weights are bit-identical to the JAX package's."""

from __future__ import annotations

import torch


def _cubic_kernel(t, A: float = -0.75):
    """OpenCV's bicubic kernel (BiCubic with A=-0.75), |t| in [0, 2).
    t: f32 tensor. The CUDA prep kernel (csrc/prep.cu `cubic`) evaluates
    the same expression tree."""
    at = t.abs()
    inner = ((A + 2.0) * at - (A + 3.0)) * at * at + 1.0
    outer = ((A * at - 5.0 * A) * at + 8.0 * A) * at - 4.0 * A
    zero = torch.zeros((), dtype=t.dtype, device=t.device)
    return torch.where(at <= 1.0, inner, torch.where(at < 2.0, outer, zero))
