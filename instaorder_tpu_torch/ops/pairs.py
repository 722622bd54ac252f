"""Pair geometry and pair-batch preprocessing (counterpart of
instaorder_tpu/ops/pairs.py).

  image (H, W, 3) + masks (N, H, W) + per-pair crop rois (P, 4)
    -> (P, sz, sz, 5) model-ready batch, channels [mask_i, mask_j, R, G, B]

Semantics match cv2 exactly: the crop window pads with 0 outside the
image, resize taps clamp to the crop window, RGB uses INTER_CUBIC
(A=-0.75, half-pixel centres) and masks INTER_NEAREST (asymmetric floor
mapping).

`build_pair_batch_matmul` is the cv2-exact dense-matrix formulation (the
parity reference; `build_pair_batches_matmul` runs it over S scenes, the
`parity` profile's prep, at the root bench's `--prep-precision` and
`--prep-stage1`); `build_pair_batches_fused` is the kernel path: one
CUDA kernel for all five channels, or the RGB kernel plus the exact mask
matmuls (ops/prep_kernels.py). The tap-gather batch functions
`build_pair_batch_rois` / `build_pair_batch` (patch and image modes of
eval/pipeline.OrderPredictor) and `build_pair_batch_shared_rgb` (its
resize mode) are the JAX package's per-roi formulation, cubic or linear.
"""

from __future__ import annotations

import numpy as np
import torch

from .resize import _cubic_kernel, resize, resize_nearest

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def pair_rois(bboxes, pair_idx):
    """Union-bbox square crop roi for each pair. bboxes (..., N, 4) f32
    xywh; pair_idx (P, 2) int. Returns (..., P, 4) f32 [x, y, size,
    size], int-truncated like the reference."""
    pair_idx = torch.as_tensor(pair_idx, dtype=torch.long,
                               device=bboxes.device)
    b1 = bboxes[..., pair_idx[:, 0], :]
    b2 = bboxes[..., pair_idx[:, 1], :]
    left = torch.minimum(b1[..., 0], b2[..., 0])
    top = torch.minimum(b1[..., 1], b2[..., 1])
    right = torch.maximum(b1[..., 0] + b1[..., 2], b2[..., 0] + b2[..., 2])
    bottom = torch.maximum(b1[..., 1] + b1[..., 3], b2[..., 1] + b2[..., 3])
    w = right - left
    h = bottom - top
    size = torch.maximum(torch.sqrt(w * h * 2.0),
                         torch.maximum(w * 1.1, h * 1.1))
    cx = left + w / 2.0
    cy = top + h / 2.0
    x = torch.trunc(cx - size / 2.0)
    y = torch.trunc(cy - size / 2.0)
    s = torch.trunc(size)
    return torch.stack([x, y, s, s], dim=-1)


def all_pair_indices(n: int, p_max: int | None = None):
    """Upper-triangle (i, j), i<j pair list, padded to p_max. Returns
    (pair_idx (P, 2) int32, valid (P,) bool) numpy arrays."""
    idx = [(i, j) for i in range(n) for j in range(i + 1, n)]
    p = len(idx)
    if p_max is None:
        p_max = p
    assert p_max >= p
    out = np.zeros((p_max, 2), np.int32)
    valid = np.zeros((p_max,), bool)
    if p:
        out[:p] = np.asarray(idx, np.int32)
        valid[:p] = True
    return out, valid


def _arange_f32(n, like):
    return torch.arange(n, dtype=torch.float32, device=like.device)


def _nearest_taps(roi_off, roi_size, out_size, src_size):
    """cv2 INTER_NEAREST indices for a cropped window. roi_off/roi_size
    (...,) f32 -> idx (..., out) int64 into the source axis, valid (...,
    out) bool (inside the image)."""
    d = _arange_f32(out_size, roi_size)
    size = roi_size[..., None]
    t = torch.floor(d * size / out_size)
    t = torch.minimum(torch.clamp(t, min=0.0), size - 1.0)
    src = t + roi_off[..., None]
    valid = (src >= 0) & (src <= src_size - 1)
    # int cast after the clip: a fractional size-1 clamp truncates
    return torch.clamp(src, 0, src_size - 1).long(), valid


def _cubic_taps(roi_off, roi_size, out_size, src_size):
    """cv2 INTER_CUBIC 4-tap indices/weights for a cropped window:
    idx (..., out, 4) int64, w (..., out, 4) f32, valid (..., out, 4).
    Taps clamp to the crop window (replicate); invalid (outside-image)
    taps are flagged for zero padding."""
    d = _arange_f32(out_size, roi_size)
    size = roi_size[..., None, None]
    f = (d + 0.5) * roi_size[..., None] / out_size - 0.5
    x0 = torch.floor(f)[..., None]
    t = f[..., None] - x0
    ks = torch.arange(-1, 3, dtype=torch.float32, device=d.device)
    w = _cubic_kernel(ks - t)
    tap = x0 + ks
    tap = torch.minimum(torch.clamp(tap, min=0.0), size - 1.0)
    src = tap + roi_off[..., None, None]
    valid = (src >= 0) & (src <= src_size - 1)
    return torch.clamp(src, 0, src_size - 1).long(), w, valid


def _linear_taps(roi_off, roi_size, out_size, src_size):
    """cv2 INTER_LINEAR 2-tap indices/weights for a cropped window: idx
    (..., out, 2) int64, w (..., out, 2) f32, valid (..., out, 2)."""
    d = _arange_f32(out_size, roi_size)
    size = roi_size[..., None, None]
    f = (d + 0.5) * roi_size[..., None] / out_size - 0.5
    x0 = torch.floor(f)[..., None]
    t = f[..., None] - x0
    w = torch.cat([1.0 - t, t], dim=-1)
    tap = x0 + torch.arange(0, 2, dtype=torch.float32, device=d.device)
    tap = torch.minimum(torch.clamp(tap, min=0.0), size - 1.0)
    src = tap + roi_off[..., None, None]
    valid = (src >= 0) & (src <= src_size - 1)
    return torch.clamp(src, 0, src_size - 1).long(), w, valid


def _seq_sum4(v):
    """Sum over a trailing axis of 4 in index order (the reference's
    reduction order for the clamp-accumulated tap mass)."""
    return ((v[..., 0] + v[..., 1]) + v[..., 2]) + v[..., 3]


def _interp_matrix(roi_off, roi_size, out_size, src_size, method='cubic'):
    """(..., out_size, src_size) dense interpolation matrix for one axis
    of cropped windows — the crop+resize as a matmul. Out-of-image taps
    are zero (the crop's zero padding); taps clamp to the crop window.
    Direct grid evaluation with the same f32 expressions as the JAX
    package, plus the clamp-accumulated tap mass at the crop borders
    (c == 0 and c == floor(roi_size - 1))."""
    if method == 'nearest':
        idx, valid = _nearest_taps(roi_off, roi_size, out_size, src_size)
        iota = torch.arange(src_size, device=idx.device)
        return ((idx[..., None] == iota) & valid[..., None]).float()
    assert method == 'cubic', method
    d = _arange_f32(out_size, roi_size)
    size = roi_size[..., None, None]
    f = (d + 0.5) * roi_size[..., None] / out_size - 0.5
    x0 = torch.floor(f)
    frac = f - x0
    ks = torch.arange(-1, 3, dtype=torch.float32, device=d.device)
    w = _cubic_kernel(ks - frac[..., None])              # (..., out, 4)
    tap = x0[..., None] + ks
    low = _seq_sum4(w * (tap < 0.0))
    chigh = torch.floor(size - 1.0)
    high = _seq_sum4(w * (tap > size - 1.0))
    c = _arange_f32(src_size, d) - roi_off[..., None, None]  # crop coords
    inwin = (c >= 0.0) & (c <= size - 1.0)
    m = _cubic_kernel((c - x0[..., None]) - frac[..., None]) * inwin
    return (m + low[..., None] * (c == 0.0)) + high[..., None] * (c == chigh)


def _normalize(rgb):
    mean = torch.as_tensor(IMAGENET_MEAN, device=rgb.device)
    std = torch.as_tensor(IMAGENET_STD, device=rgb.device)
    return (rgb / 255.0 - mean) / std


def _mask_pair_batch(masks, pair_idx, rois, out_size):
    """Both instance masks of every pair as nearest one-hot matmuls ->
    (..., P, 2, out, out) f32, exact over {0, 1} data. masks (..., N, H,
    W); pair_idx (P, 2); rois (..., P, 4): one scene, or S scenes in one
    batched product."""
    H, W = masks.shape[-2], masks.shape[-1]
    pidx = torch.as_tensor(pair_idx, dtype=torch.long, device=masks.device)
    wyn = _interp_matrix(rois[..., 1], rois[..., 3], out_size, H, 'nearest')
    wxn = _interp_matrix(rois[..., 0], rois[..., 2], out_size, W, 'nearest')
    sel = masks.float().index_select(-3, pidx.reshape(-1)).reshape(
        *masks.shape[:-3], pidx.shape[0], 2, H, W)
    m1 = torch.einsum('...pjw,...pmhw->...pmhj', wxn, sel)
    return torch.einsum('...pih,...pmhj->...pmij', wyn, m1)


def _with_masks(m, rgb, dtype):
    """(..., P, 2, out, out) masks + (..., P, out, out, 3) RGB ->
    (..., P, out, out, 5) in `dtype`, channels [mask_i, mask_j, R, G, B]."""
    return torch.cat([m[..., 0, :, :, None].to(dtype),
                      m[..., 1, :, :, None].to(dtype), rgb.to(dtype)], dim=-1)


# the root bench's --prep-precision names
PRECISIONS = ('default', 'high', 'highest')


def _mm(a, b, precision):
    """a (..., M, K) @ b (..., K, N) -> f32 at a TPU matmul precision:
      'highest'  f32 operands (TF32 off on the card: f32 on the CUDA
                 cores);
      'high'     the 3-pass bf16 split: with hi = bf16(x) and lo =
                 bf16(x - hi), the products hi.hi + hi.lo + lo.hi summed
                 in f32 (one product over K tripled: [hi_a | hi_a | lo_a]
                 . [hi_b; lo_b; hi_b]);
      'default'  1-pass: bf16 operands, f32 sums.
    A product of two bf16 values is exact in f32, so on the card the
    bf16 passes run on the tensor cores (torch.bmm with an f32 output)
    and on the CPU as an f32 product of the bf16 values: the same sums
    of exact products, in another order."""
    if precision == 'highest':
        return a @ b
    if precision not in PRECISIONS:
        raise ValueError(f'precision must be one of {PRECISIONS}, got '
                         f'{precision!r}')
    a16, b16 = a.bfloat16(), b.bfloat16()
    if precision == 'high':
        a_lo = (a - a16.float()).bfloat16()
        b_lo = (b - b16.float()).bfloat16()
        a16 = torch.cat([a16, a16, a_lo], dim=-1)
        b16 = torch.cat([b16, b_lo, b16], dim=-2)
    lead = a16.shape[:-2]
    if a16.is_cuda:
        out = torch.bmm(a16.reshape(-1, *a16.shape[-2:]),
                        b16.reshape(-1, *b16.shape[-2:]),
                        out_dtype=torch.float32)
    else:
        out = a16.float() @ b16.float()
    return out.reshape(*lead, *out.shape[-2:])


def _rgb_pair_batch(image, rois, out_size, normalize=True,
                    precision='highest', stage1_dtype=None):
    """The RGB channels of every pair as two dense cubic matmuls at
    `precision` (_mm): image (..., H, W, 3) raw [0, 255]; rois (..., P,
    4) -> (..., P, out, out, 3) f32 (normalised, or the integers
    0..255). stage1_dtype: storage dtype of the (P, H, out, 3) row-
    interpolated intermediate (torch.bfloat16 rounds it; default f32)."""
    H, W, C = image.shape[-3:]
    lead = image.shape[:-3]
    wy = _interp_matrix(rois[..., 1], rois[..., 3], out_size, H)
    wx = _interp_matrix(rois[..., 0], rois[..., 2], out_size, W)
    P = wx.shape[-3]
    # stage 1, the x axis: (P * out_j, W) . (W, H * C) per scene
    img = image.float().transpose(-3, -2).reshape(*lead, W, H * C)
    stage1 = _mm(wx.reshape(*lead, P * out_size, W), img, precision)
    stage1 = stage1.reshape(*lead, P, out_size, H, C).transpose(-3, -2)
    stage1 = stage1.reshape(*lead, P, H, out_size * C)
    if stage1_dtype is not None:
        stage1 = stage1.to(stage1_dtype).float()
    # stage 2, the y axis: (out_i, H) . (H, out_j * C) per pair
    rgb = _mm(wy, stage1, precision).reshape(*lead, P, out_size, out_size,
                                             C)
    rgb = torch.clamp(torch.round(rgb), 0.0, 255.0)
    return _normalize(rgb) if normalize else rgb


def build_pair_batch_matmul(image, masks, pair_idx, rois, out_size=256,
                            normalize=True, dtype=None, precision='high',
                            stage1_dtype=None):
    """Dense-matrix pair batch. image (..., H, W, 3) f32 raw [0, 255];
    masks (..., N, H, W) {0,1}; pair_idx (P, 2); rois (..., P, 4).
    Returns (..., P, out, out, 5) in `dtype` (default f32). precision
    ('default' | 'high' | 'highest', the JAX `Precision` names, default
    HIGH as there) and stage1_dtype steer the RGB matmuls (_mm,
    _rgb_pair_batch); the masks are one-hot matmuls, exact at any
    precision."""
    rgb = _rgb_pair_batch(image, rois, out_size, normalize, precision,
                          stage1_dtype)
    m = _mask_pair_batch(masks, pair_idx, rois, out_size)
    return _with_masks(m, rgb, rgb.dtype if dtype is None else dtype)


def build_pair_batches_matmul(images, masks, pair_idx, rois, out_size=256,
                              normalize=True, dtype=None, precision='high',
                              stage1_dtype=None):
    """`build_pair_batch_matmul` over S scenes as batched products (the
    JAX bench vmaps it): images (S, H, W, 3), masks (S, N, H, W), rois
    (S, P, 4) -> (S*P, out, out, 5)."""
    x = build_pair_batch_matmul(images, masks, pair_idx, rois,
                                out_size=out_size, normalize=normalize,
                                dtype=dtype, precision=precision,
                                stage1_dtype=stage1_dtype)
    return x.reshape(-1, *x.shape[2:])


def build_pair_batches_fused(images, masks, pair_idx, rois, out_size=256,
                             passes=3, fuse_masks=False,
                             dtype=torch.bfloat16):
    """Multi-scene pair prep through the prep kernels
    (ops/prep_kernels.py). images (S, H, W, 3) f32 raw; masks
    (S, N, H, W) {0,1}; pair_idx (P, 2); rois (S, P, 4) ->
    (S*P, out, out, 5) in `dtype`. passes: 3 = f32 weights (serving
    precision), 1 = bf16 weights and row values (the serving-d1 knob).

    fuse_masks: all five channels in one kernel (`fused_prep_pairs`);
    otherwise the RGB kernel (`fused_prep_rgb`) plus the exact one-hot
    mask matmuls of `_mask_pair_batch`, as the JAX default. Either
    writes bf16 or f32.

    The kernels read their 4x4 cubic taps directly, so any image size
    works (no 8-multiple padding) and there is no per-call pair cap."""
    from .prep_kernels import fused_prep_pairs, fused_prep_rgb
    if fuse_masks:
        return fused_prep_pairs(images, masks, pair_idx, rois,
                                out_size=out_size, passes=passes,
                                out_dtype=dtype)
    rgb = fused_prep_rgb(images, rois, out_size=out_size, passes=passes,
                         out_dtype=dtype)
    m = _mask_pair_batch(masks, pair_idx, rois, out_size)
    return _with_masks(m.reshape(-1, *m.shape[2:]), rgb, dtype)


def _crop_resize_interp(img, rois, out_size, method='cubic'):
    """Per-roi crop + resize of one image by tap gathers: img (H, W, C)
    f32, rois (P, 4) xywh -> (P, out, out, C). Rows first, then columns,
    each a sum over the taps in order, out-of-image taps weighted 0."""
    H, W, C = img.shape
    taps = _cubic_taps if method == 'cubic' else _linear_taps
    yi, wy, vy = taps(rois[:, 1], rois[:, 3], out_size, H)
    xi, wx, vx = taps(rois[:, 0], rois[:, 2], out_size, W)
    wy, wx = wy * vy, wx * vx
    P, K = rois.shape[0], yi.shape[-1]
    rows = None                                  # (P, out, W, C)
    for k in range(K):
        t = img[yi[..., k]] * wy[..., k, None, None]
        rows = t if rows is None else rows + t
    out = None                                   # (P, out, out, C)
    for k in range(K):
        idx = xi[..., k][:, None, :, None].expand(P, out_size, out_size, C)
        t = torch.gather(rows, 2, idx) * wx[:, None, :, k, None]
        out = t if out is None else out + t
    return out


def _crop_resize_nearest(masks, rois, out_size):
    """masks (P, H, W), rois (P, 4) -> (P, out, out) nearest with 0-pad."""
    P, H, W = masks.shape
    yi, vy = _nearest_taps(rois[:, 1], rois[:, 3], out_size, H)
    xi, vx = _nearest_taps(rois[:, 0], rois[:, 2], out_size, W)
    ar = torch.arange(P, device=masks.device)
    out = masks[ar[:, None, None], yi[:, :, None], xi[:, None, :]]
    return out * (vy[:, :, None] & vx[:, None, :]).to(masks.dtype)


def build_pair_batch_rois(image, masks, pair_idx, rois, out_size=256,
                          normalize=True, rgb_method='cubic'):
    """Pair batch from explicit per-pair crop rois by tap gathers.
    image (H, W, 3) f32 raw [0, 255]; masks (N, H, W) {0,1}; pair_idx
    (P, 2) (padded with (0, 0)); rois (P, 4) f32 xywh (may leave the
    image). rgb_method: 'cubic' (patch mode) or 'linear' (image mode).
    Returns (P, out, out, 5) f32 [mask_i, mask_j, normalised RGB]."""
    rois = rois.float()
    rgb = _crop_resize_interp(image.float(), rois, out_size, rgb_method)
    # cv2 resizes uint8 (saturating, rounded) before the float conversion
    rgb = torch.clamp(torch.round(rgb), 0.0, 255.0)
    if normalize:
        rgb = _normalize(rgb)
    pidx = torch.as_tensor(pair_idx, dtype=torch.long, device=image.device)
    mk = masks.float()
    mi = _crop_resize_nearest(mk[pidx[:, 0]], rois, out_size)
    mj = _crop_resize_nearest(mk[pidx[:, 1]], rois, out_size)
    return torch.cat([mi[..., None], mj[..., None], rgb], dim=-1)


def build_pair_batch(image, masks, bboxes, pair_idx, out_size=256,
                     normalize=True, rgb_method='cubic'):
    """The patch-mode pair batch: per-pair union-bbox square crops
    (pair_rois) -> (P, out, out, 5)."""
    rois = pair_rois(bboxes, pair_idx)
    return build_pair_batch_rois(image, masks, pair_idx, rois,
                                 out_size=out_size, normalize=normalize,
                                 rgb_method=rgb_method)


def build_pair_batch_shared_rgb(image, masks, pair_idx, out_size=384,
                                normalize=True, rgb_method='linear'):
    """The resize-mode pair batch: one shared full-image resize
    ('linear' as the train dataset, 'cubic' as the eval transform), the
    masks resized nearest and indexed per pair -> (P, out, out, 5)."""
    rgb = resize(image.float().permute(2, 0, 1), out_size, out_size,
                 rgb_method).permute(1, 2, 0)
    rgb = torch.clamp(torch.round(rgb), 0.0, 255.0)
    if normalize:
        rgb = _normalize(rgb)
    masks_r = resize_nearest(masks.float(), out_size, out_size)
    pidx = torch.as_tensor(pair_idx, dtype=torch.long, device=image.device)
    P = pidx.shape[0]
    return torch.cat([masks_r[pidx[:, 0], ..., None],
                      masks_r[pidx[:, 1], ..., None],
                      rgb[None].expand(P, out_size, out_size, 3)], dim=-1)
