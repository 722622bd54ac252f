"""Image resize with OpenCV index semantics (counterpart of
instaorder_tpu/ops/resize.py: `nearest_indices`, `resize_weights_linear`,
`_cubic_kernel`, `resize_weights_cubic`, `resize_nearest`, `resize`).

Linear and cubic resizes over a fixed (src -> dst) size pair are
separable linear maps: the row and column interpolation matrices are
built once per shape pair on the host (numpy, cached) and the resize is
two f32 matmuls (TF32 off on the card, `device.resolve_device`).

Index conventions (OpenCV):
  INTER_NEAREST: src = floor(dst * src_size / dst_size)        (asymmetric)
  INTER_LINEAR / INTER_CUBIC: src = (dst + 0.5) * scale - 0.5  (half-pixel)
  out-of-range taps clamp to the edge (BORDER_REPLICATE); INTER_CUBIC
  uses the kernel with A = -0.75.

`_cubic_kernel` evaluates the same f32 expressions as the JAX package,
left to right, so the prep weights are bit-identical to it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _cubic_kernel(t, A: float = -0.75):
    """OpenCV's bicubic kernel (BiCubic with A=-0.75), |t| in [0, 2).
    t: a float tensor (f32 in the preps, f64 for the host resize
    matrices). The CUDA prep kernel (csrc/prep.cu `cubic`) evaluates the
    same expression tree."""
    at = t.abs()
    inner = ((A + 2.0) * at - (A + 3.0)) * at * at + 1.0
    outer = ((A * at - 5.0 * A) * at + 8.0 * A) * at - 4.0 * A
    zero = torch.zeros((), dtype=t.dtype, device=t.device)
    return torch.where(at <= 1.0, inner, torch.where(at < 2.0, outer, zero))


def nearest_indices(src: int, dst: int) -> np.ndarray:
    """cv2.INTER_NEAREST source index for each dst position."""
    idx = np.floor(np.arange(dst) * (src / dst)).astype(np.int32)
    return np.minimum(idx, src - 1)


@functools.lru_cache(maxsize=256)
def resize_weights_linear(src: int, dst: int) -> np.ndarray:
    """(dst, src) matrix W with out = W @ in, cv2.INTER_LINEAR semantics."""
    scale = src / dst
    fx = (np.arange(dst) + 0.5) * scale - 0.5
    x0 = np.floor(fx).astype(np.int64)
    t = fx - x0
    W = np.zeros((dst, src), dtype=np.float32)
    for tap, wgt in ((x0, 1.0 - t), (x0 + 1, t)):
        tap = np.clip(tap, 0, src - 1)
        np.add.at(W, (np.arange(dst), tap), wgt.astype(np.float32))
    return W


@functools.lru_cache(maxsize=256)
def resize_weights_cubic(src: int, dst: int) -> np.ndarray:
    """(dst, src) matrix with cv2.INTER_CUBIC semantics (4-tap, A=-0.75)."""
    scale = src / dst
    fx = (np.arange(dst) + 0.5) * scale - 0.5
    x0 = np.floor(fx).astype(np.int64)
    t = fx - x0
    W = np.zeros((dst, src), dtype=np.float32)
    rows = np.arange(dst)
    for k in range(-1, 3):
        tap = np.clip(x0 + k, 0, src - 1)
        wgt = _cubic_kernel(torch.from_numpy(k - t)).numpy()
        np.add.at(W, (rows, tap), wgt.astype(np.float32))
    return W


def resize_nearest(img, out_h: int, out_w: int):
    """Nearest resize of the trailing two dims of a (..., H, W) tensor."""
    h, w = img.shape[-2], img.shape[-1]
    yi = torch.as_tensor(nearest_indices(h, out_h), dtype=torch.long,
                         device=img.device)
    xi = torch.as_tensor(nearest_indices(w, out_w), dtype=torch.long,
                         device=img.device)
    return img.index_select(-2, yi).index_select(-1, xi)


def resize(img, out_h: int, out_w: int, method: str = 'linear'):
    """Resize the trailing two dims of `img` (any leading batch dims).
    method: 'nearest' | 'linear' | 'cubic'; linear and cubic are two f32
    matmuls with the static weight matrices (the JAX package's
    `Precision.HIGHEST` route)."""
    if method == 'nearest':
        return resize_nearest(img, out_h, out_w)
    h, w = img.shape[-2], img.shape[-1]
    make = resize_weights_linear if method == 'linear' \
        else resize_weights_cubic
    dtype = img.dtype if img.is_floating_point() else torch.float32
    wy = torch.as_tensor(make(h, out_h), device=img.device).to(dtype)
    wx = torch.as_tensor(make(w, out_w), device=img.device).to(dtype)
    out = torch.einsum('Hh,...hw->...Hw', wy, img.to(dtype))
    return torch.einsum('Ww,...Hw->...HW', wx, out)
