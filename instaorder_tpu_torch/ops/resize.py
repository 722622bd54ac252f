"""Image resize with OpenCV index semantics (counterpart of
instaorder_tpu/ops/resize.py: `nearest_indices`, `resize_weights_linear`,
`_cubic_kernel`, `resize_weights_cubic`,
`resize_weights_linear_align_corners`, `upsample_bilinear_align_corners`,
`resize_nearest`, `resize`).

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


@functools.lru_cache(maxsize=256)
def resize_weights_linear_align_corners(src: int, dst: int) -> np.ndarray:
    """(dst, src) bilinear weights with torch's align_corners=True mapping
    (src = dst * (src - 1) / (dst - 1)); the MiDaS fusion blocks' x2
    upsample (reference midas/blocks.py:191-193)."""
    if dst == 1 or src == 1:
        W = np.zeros((dst, src), np.float32)
        W[:, 0] = 1.0
        return W
    fx = np.arange(dst) * ((src - 1) / (dst - 1))
    x0 = np.floor(fx).astype(np.int64)
    t = (fx - x0).astype(np.float32)
    W = np.zeros((dst, src), dtype=np.float32)
    rows = np.arange(dst)
    np.add.at(W, (rows, np.clip(x0, 0, src - 1)), 1.0 - t)
    np.add.at(W, (rows, np.clip(x0 + 1, 0, src - 1)), t)
    return W


def _separable(x, wy, wx):
    """Wy @ x @ Wx^T over the trailing two dims of x (two f32 matmuls)."""
    wy = torch.as_tensor(wy, device=x.device).to(x.dtype)
    wx = torch.as_tensor(wx, device=x.device).to(x.dtype)
    out = torch.einsum('Hh,...hw->...Hw', wy, x)
    return torch.einsum('Ww,...Hw->...HW', wx, out)


def upsample_bilinear_align_corners(x, out_h: int, out_w: int):
    """torch F.interpolate(mode='bilinear', align_corners=True) on the
    trailing two dims of a (..., H, W) float tensor, as the separable map
    of `resize_weights_linear_align_corners`."""
    h, w = x.shape[-2], x.shape[-1]
    return _separable(x, resize_weights_linear_align_corners(h, out_h),
                      resize_weights_linear_align_corners(w, out_w))


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
    return _separable(img.to(dtype), make(h, out_h), make(w, out_w))


# ---------------------------------------------------------------------------
# host (numpy) resizes of uint8 images, as cv2.resize gives them: the
# training datasets' crops (data/datasets.py)
# ---------------------------------------------------------------------------

_COEF_SCALE = 2048          # cv2's INTER_RESIZE_COEF_SCALE (11 bits)


def _linear_taps_u8(src: int, dst: int, clamp_weights: bool = True):
    """cv2.INTER_LINEAR's taps and 11-bit weights for 8-bit images: the
    source coordinate in f32, each weight rounded on its own (so a pair
    may not sum to 2048). clamp_weights (cv2's horizontal pass): a tap
    off either edge moves to the edge with weights (2048, 0). Else (its
    vertical pass) the weights stay and only the rows clamp, so an edge
    row gets the rounded pair's sum."""
    fx = ((np.arange(dst) + 0.5) * (src / dst) - 0.5).astype(np.float32)
    x0 = np.floor(fx).astype(np.int64)
    t = fx - x0.astype(np.float32)
    if clamp_weights:
        edge = (x0 < 0) | (x0 >= src - 1)
        t = np.where(edge, np.float32(0), t)
    one = np.float32(_COEF_SCALE)
    a0 = np.rint((np.float32(1) - t) * one).astype(np.int64)
    a1 = np.rint(t * one).astype(np.int64)
    return (np.clip(x0, 0, src - 1), np.clip(x0 + 1, 0, src - 1), a0, a1)


def resize_linear_u8(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """cv2.resize(img, (out_w, out_h), interpolation=cv2.INTER_LINEAR) of
    an (H, W[, C]) uint8 image, in cv2's fixed-point arithmetic: the
    horizontal pass sums 11-bit weighted taps exactly, the vertical pass
    rounds as cv2's vector kernel does ((S >> 4) * b >> 16 per tap, then
    (t0 + t1 + 2) >> 2, saturated). A float resize rounded to uint8
    differs from cv2 by one on ~10% of the values; this one agrees with
    cv2 on every value, upscaling (edge rows) included."""
    h, w = img.shape[:2]
    x0, x1, a0, a1 = _linear_taps_u8(w, out_w)
    y0, y1, b0, b1 = _linear_taps_u8(h, out_h, clamp_weights=False)
    extra = (None,) * (img.ndim - 2)
    a0, a1 = a0[(None, slice(None)) + extra], a1[(None, slice(None)) + extra]
    b0, b1 = b0[(slice(None), None) + extra], b1[(slice(None), None) + extra]
    src = img.astype(np.int64)
    row = src[:, x0] * a0 + src[:, x1] * a1
    t0 = ((row[y0] >> 4) * b0) >> 16
    t1 = ((row[y1] >> 4) * b1) >> 16
    return np.clip((t0 + t1 + 2) >> 2, 0, 255).astype(np.uint8)


def resize_cubic_u8(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """cv2.resize(..., interpolation=cv2.INTER_CUBIC) of an (H, W, C)
    uint8 image: `resize` ('cubic', f32) on the CPU, rounded to the
    nearest and saturated to uint8 as cv2 saturates."""
    x = torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)
    out = resize(x.float(), out_h, out_w, 'cubic').permute(1, 2, 0)
    return np.clip(np.rint(out.numpy()), 0, 255).astype(np.uint8)


def cv2_nearest_indices(src: int, dst: int) -> np.ndarray:
    """cv2.resize's INTER_NEAREST source index for each dst position:
    floor(x * (1 / (dst / src))), the scale inverted in double as cv2
    inverts it. `nearest_indices` (floor(x * (src / dst)), the JAX
    package's on-device rule, which the preps keep) takes the index
    below where x * src / dst is an integer that the other rounding
    leaves just under it (at 114 of the 2,796 pairs src 1-699 x dst 36,
    48, 64, 256)."""
    idx = np.floor(np.arange(dst) * (1.0 / (dst / src))).astype(np.int64)
    return np.minimum(idx, src - 1)


def resize_nearest_np(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """cv2.resize(..., interpolation=cv2.INTER_NEAREST) of an (H, W[, C])
    array (`cv2_nearest_indices` on both axes)."""
    h, w = img.shape[:2]
    return img[cv2_nearest_indices(h, out_h)][:, cv2_nearest_indices(w,
                                                                      out_w)]
