"""Kernels 1 and 5: the fused pair prep (csrc/prep.cu).

Replaces two TPU kernels of instaorder_tpu/ops/prep_pallas.py:
  fused_prep_pairs <- `fused_prep_pairs` (kernel body `_prep5_kernel`):
      per (scene, pair) union-bbox crop, cv2 cubic RGB resize, uint8
      round/clip, ImageNet normalisation and nearest resize of both
      instance masks, written straight to NHWC (S*P, out, out, 5) bf16,
      or f32 with out_dtype=torch.float32 (the TPU kernel's `out_dtype`;
      eval/pipeline.OrderPredictor's default `prep_dtype`);
  fused_prep_rgb   <- `fused_prep_rgb` (`_prep_rgb_kernel`): the RGB
      channels only, (S*P, out, out, 3) NHWC (the TPU kernel writes
      channel-major), normalised or the raw integers 0..255, in bf16 or,
      with out_dtype=torch.float32, f32 (the TPU kernel's `out_dtype`;
      the f32 model's `--prep-rgb pallas` route).

Bound on the H100: memory (the 5 or 3 * out*out bf16 or f32 output per
pair plus each scene's image and masks read once, over 3.35 TB/s). The TPU
kernels' MXU trick — contracting dense interpolation windows as
matmuls — does not carry over. The CUDA kernel runs the two separable
tap passes: a block owns one pair's band of BAND_ROWS output rows (and
up to TILE_COLS columns, one a thread), computes the band's y taps once
into shared memory and each column's x taps once in registers, and
keeps a ring of the last four stage-1 row values per column, keyed by
the unclamped tap index, so a stage-1 value is computed once per band
and not once per output row that reads it. Adjacent x taps are read
with 16-byte loads; each group of output rows is staged in shared
memory and written as one contiguous range of `out` with 16-byte
stores. tests/test_torch_prep_reuse.py holds a model of that schedule
against the plain versions.

The `_plain` versions are the same functions in PyTorch: the same
merged tap weights (bit-identical to the dense matrix of
ops/pairs._interp_matrix), the same separable order (sum over x first,
each sum in tap order) and the same `passes` contract, so kernel and
plain version agree on every value. (Run on the card, the plain
version's `/ out_size` becomes a multiply by the reciprocal in
PyTorch, which can move a tap by one ulp where out_size is not a power
of two; the kernel divides, as the plain version does on the CPU. The
normalisation does not have that fault: the plain versions map the
uint8 result through a table of the 256 output values computed on the
CPU, as the kernel maps it through its own table.)
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build
from .pairs import IMAGENET_MEAN, IMAGENET_STD, _nearest_taps, _seq_sum4
from .resize import _cubic_kernel

# The CUDA kernel's block: a band of BAND_ROWS output rows (at most 64)
# and up to TILE_COLS output columns (csrc/prep.cu kTileCols).
BAND_ROWS = 32
TILE_COLS = 256


def _merged_cubic_taps(off, size, out_size, src_size, passes):
    """Per output index the 4 cubic taps as (idx (..., out, 4) int64,
    w (..., out, 4) f32). A tap's weight is the dense matrix entry of
    its (crop-clamped) column — interior kernel weight plus the clamped
    taps' mass at the crop borders — given once per distinct column
    (zero for a repeat) and zero for a column outside the image. With
    passes=1 the weights are rounded to bf16."""
    d = torch.arange(out_size, dtype=torch.float32, device=size.device)
    f = (d + 0.5) * size[..., None] / out_size - 0.5
    x0 = torch.floor(f)[..., None]
    frac = f[..., None] - x0
    ks = torch.arange(-1, 3, dtype=torch.float32, device=d.device)
    w4 = _cubic_kernel(ks - frac)
    tap = x0 + ks
    lim = size[..., None, None] - 1.0
    low = _seq_sum4(w4 * (tap < 0.0))
    high = _seq_sum4(w4 * (tap > lim))
    chigh = torch.floor(lim)
    c = torch.minimum(torch.clamp(tap, min=0.0), chigh)
    inwin = (c >= 0.0) & (c <= lim)
    m = _cubic_kernel((c - x0) - frac) * inwin
    ent = (m + low[..., None] * (c == 0.0)) + high[..., None] * (c == chigh)
    dup = torch.zeros_like(c, dtype=torch.bool)
    dup[..., 1:] = c[..., 1:] == c[..., :-1]
    src = c + off[..., None, None]
    valid = (src >= 0.0) & (src <= src_size - 1)
    w = torch.where(dup | ~valid, torch.zeros_like(ent), ent)
    if passes == 1:
        w = w.bfloat16().float()
    return torch.clamp(src, 0, src_size - 1).long(), w


def _check_passes(passes):
    if passes not in (1, 3):
        raise ValueError(f'passes must be 1 or 3, got {passes}')


def _check_out_dtype(out_dtype):
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f'out_dtype must be torch.bfloat16 or '
                         f'torch.float32, got {out_dtype}')


def _normalize_u8(rgb):
    """ImageNet normalisation of the integers 0..255 in `rgb` (..., 3)
    through a table of the 256 values per channel, (v / 255 - mean) /
    std computed in f32 on the CPU (so the values do not depend on the
    device; csrc/prep.cu's `lut`)."""
    v = torch.arange(256, dtype=torch.float32)[:, None]
    lut = ((v / 255.0 - torch.as_tensor(IMAGENET_MEAN))
           / torch.as_tensor(IMAGENET_STD)).to(rgb.device)
    return torch.gather(lut, 0, rgb.long().reshape(-1, 3)).reshape(rgb.shape)


def _rgb_plain(img, r, out_size, passes, normalize):
    """One scene's RGB: img (H, W, 3) f32, rois r (P, 4) -> (P, out, out,
    3) f32 (normalised, or the integers 0..255)."""
    H, W, _ = img.shape
    iy, wy = _merged_cubic_taps(r[:, 1], r[:, 3], out_size, H, passes)
    ix, wx = _merged_cubic_taps(r[:, 0], r[:, 2], out_size, W, passes)
    # stage 1 (x axis): (P, H, out, 3) row values
    g = img[:, ix].permute(1, 0, 2, 4, 3)            # (P, H, out, 3, 4)
    s1 = _seq_sum4(g * wx[:, None, :, None, :])
    if passes == 1:
        s1 = s1.bfloat16().float()
    # stage 2 (y axis): (P, out_i, out_j, 3)
    ar = torch.arange(r.shape[0], device=img.device)
    g2 = s1[ar[:, None, None], iy].permute(0, 1, 3, 4, 2)
    rgb = torch.clamp(torch.round(_seq_sum4(g2 * wy[:, :, None, None, :])),
                      0.0, 255.0)
    return _normalize_u8(rgb) if normalize else rgb


def fused_prep_rgb_plain(images, rois, out_size=256, normalize=True,
                         passes=3, out_dtype=torch.bfloat16):
    """The RGB prep kernel's function in PyTorch (any device). images
    (S, H, W, 3) f32 raw [0, 255]; rois (S, P, 4) f32 xywh ->
    (S*P, out, out, 3) in out_dtype (bf16 or f32: the same f32 values,
    rounded to bf16 or not)."""
    _check_passes(passes)
    _check_out_dtype(out_dtype)
    return torch.cat([
        _rgb_plain(images[s].float(), rois[s].float(), out_size, passes,
                   normalize) for s in range(images.shape[0])]).to(out_dtype)


def fused_prep_pairs_plain(images, masks, pair_idx, rois, out_size=256,
                           passes=3, out_dtype=torch.bfloat16):
    """The prep kernel's function in PyTorch (any device). images
    (S, H, W, 3) f32 raw [0, 255]; masks (S, N, H, W) {0,1}; pair_idx
    (P, 2); rois (S, P, 4) f32 xywh -> (S*P, out, out, 5) in out_dtype
    (bf16 or f32: the same f32 values, rounded to bf16 or not)."""
    _check_passes(passes)
    _check_out_dtype(out_dtype)
    S, H, W, _ = images.shape
    pidx = torch.as_tensor(pair_idx, dtype=torch.long, device=images.device)
    P = pidx.shape[0]
    out = torch.empty((S * P, out_size, out_size, 5), dtype=out_dtype,
                      device=images.device)
    ar = torch.arange(P, device=images.device)
    for s in range(S):
        r = rois[s].float()
        ny, vy = _nearest_taps(r[:, 1], r[:, 3], out_size, H)
        nx, vx = _nearest_taps(r[:, 0], r[:, 2], out_size, W)
        valid = vy[:, :, None] & vx[:, None, :]
        sl = slice(s * P, (s + 1) * P)
        for ch in range(2):
            mk = masks[s][pidx[:, ch]].float()              # (P, H, W)
            mv = mk[ar[:, None, None], ny[:, :, None], nx[:, None, :]]
            out[sl, :, :, ch] = (mv * valid).to(out_dtype)
        out[sl, :, :, 2:] = _rgb_plain(images[s].float(), r, out_size,
                                       passes, True).to(out_dtype)
    return out


def fused_prep_pairs(images, masks, pair_idx, rois, out_size=256,
                     passes=3, out_dtype=torch.bfloat16):
    """5-channel pair prep -> (S*P, out, out, 5) in out_dtype (bf16 or
    f32). On CUDA tensors it launches the CUDA kernel (one launch,
    counted in `fused_prep_pairs.launches`); on CPU tensors it runs
    `fused_prep_pairs_plain`.

    CUDA inputs: images (S, H, W, 3) f32, masks (S, N, H, W) uint8,
    pair_idx (P, 2) int32, rois (S, P, 4) f32, all contiguous on one
    device. pair_idx entries must index the N masks (a host pair_idx is
    range-checked before upload)."""
    if images.device.type == 'cpu':
        return fused_prep_pairs_plain(images, masks, pair_idx, rois,
                                      out_size=out_size, passes=passes,
                                      out_dtype=out_dtype)
    _check_passes(passes)
    _check_out_dtype(out_dtype)
    dev = images.device
    if not isinstance(pair_idx, torch.Tensor) or pair_idx.device != dev:
        host = np.asarray(pair_idx if not isinstance(pair_idx, torch.Tensor)
                          else pair_idx.cpu())
        if host.size and (host.min() < 0 or host.max() >= masks.shape[1]):
            raise ValueError('pair_idx out of range of the masks')
        pair_idx = torch.as_tensor(host, dtype=torch.int32, device=dev)
    S, H, W, C = images.shape
    P = pair_idx.shape[0]
    checks = [
        (images.dtype == torch.float32 and C == 3, 'images (S,H,W,3) f32'),
        (masks.dtype == torch.uint8 and masks.dim() == 4
         and masks.shape[0] == S and tuple(masks.shape[2:]) == (H, W),
         'masks (S,N,H,W) uint8'),
        (pair_idx.dtype == torch.int32 and tuple(pair_idx.shape) == (P, 2),
         'pair_idx (P,2) int32'),
        (rois.dtype == torch.float32 and tuple(rois.shape) == (S, P, 4),
         'rois (S,P,4) f32'),
    ]
    for ok, what in checks:
        if not ok:
            raise ValueError(f'fused_prep_pairs expects {what}')
    for t in (images, masks, pair_idx, rois):
        if t.device != dev or not t.is_contiguous():
            raise ValueError('fused_prep_pairs inputs must be contiguous '
                             f'and on {dev}')
    out = torch.empty((S * P, out_size, out_size, 5), dtype=out_dtype,
                      device=dev)
    rc = _build.launch(
        'io_prep_pairs', dev, images.data_ptr(), masks.data_ptr(),
        pair_idx.data_ptr(), rois.data_ptr(), out.data_ptr(), S, P,
        masks.shape[1], H, W, out_size, passes, BAND_ROWS,
        int(out_dtype == torch.float32))
    _build.check(rc, 'fused_prep_pairs')
    fused_prep_pairs.launches += 1
    return out


def fused_prep_rgb(images, rois, out_size=256, normalize=True, passes=3,
                   out_dtype=torch.bfloat16):
    """RGB-only pair prep -> (S*P, out, out, 3) in out_dtype (bf16 or
    f32). On CUDA tensors it launches the CUDA kernel (one launch,
    counted in `fused_prep_rgb.launches`); on CPU tensors it runs
    `fused_prep_rgb_plain`.

    CUDA inputs: images (S, H, W, 3) f32, rois (S, P, 4) f32, contiguous
    on one device."""
    if images.device.type == 'cpu':
        return fused_prep_rgb_plain(images, rois, out_size=out_size,
                                    normalize=normalize, passes=passes,
                                    out_dtype=out_dtype)
    _check_passes(passes)
    _check_out_dtype(out_dtype)
    dev = images.device
    S, H, W, C = images.shape
    if images.dtype != torch.float32 or C != 3:
        raise ValueError('fused_prep_rgb expects images (S,H,W,3) f32')
    if (rois.dtype != torch.float32 or rois.dim() != 3
            or rois.shape[0] != S or rois.shape[2] != 4):
        raise ValueError('fused_prep_rgb expects rois (S,P,4) f32')
    for t in (images, rois):
        if t.device != dev or not t.is_contiguous():
            raise ValueError('fused_prep_rgb inputs must be contiguous and '
                             f'on {dev}')
    P = rois.shape[1]
    out = torch.empty((S * P, out_size, out_size, 3), dtype=out_dtype,
                      device=dev)
    rc = _build.launch(
        'io_prep_rgb', dev, images.data_ptr(), rois.data_ptr(),
        out.data_ptr(), S, P, H, W, out_size, passes, int(bool(normalize)),
        BAND_ROWS, int(out_dtype == torch.float32))
    _build.check(rc, 'fused_prep_rgb')
    fused_prep_rgb.launches += 1
    return out


fused_prep_pairs.launches = 0
fused_prep_rgb.launches = 0
