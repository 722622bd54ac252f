"""Host-side (numpy) bbox/mask geometry (counterpart of
instaorder_tpu/utils/geometry.py, copied whole).

Behavioral parity with the reference's `utils/data_utils.py`
(POSTECH-CVLab/InstaOrder):
  combine_bbox            <- utils/data_utils.py:61-72
  mask_to_bbox            <- utils/data_utils.py:75-84
  bbox_iou                <- utils/data_utils.py:87-101
  crop_padding            <- utils/data_utils.py:104-124
  place_eraser(_in_ratio) <- utils/data_utils.py:127-160
  scissor_mask(_force)    <- utils/data_utils.py:163-196
  mask_aug / base_aug     <- utils/data_utils.py:199-235
  EraserSetter            <- utils/data_utils.py:238-249
  get_closest_int_multiple_of <- utils/data_utils.py:13-17

These run in the CPU ingest path (annotation -> fixed-shape batch), so
they stay numpy. The readers use `mask_to_bbox`; the training
datasets the eraser and augmentation helpers. All bboxes are xywh
unless stated otherwise.
"""

from __future__ import annotations

import numpy as np

from ..ops.resize import resize_nearest_np


def get_closest_int_multiple_of(n: int, m: int) -> int:
    """Round ``n`` to the nearest multiple of ``m`` (ties round up)."""
    r = n % m
    return n + (m - r) if r >= m // 2 else n - r


def combine_bbox(bboxes: np.ndarray) -> np.ndarray:
    """Union of N xywh boxes -> one xywh box. bboxes: (N, 4)."""
    bboxes = np.asarray(bboxes)
    left = bboxes[:, 0].min()
    top = bboxes[:, 1].min()
    right = (bboxes[:, 0] + bboxes[:, 2]).max()
    bottom = (bboxes[:, 1] + bboxes[:, 3]).max()
    return np.array([left, top, right - left, bottom - top])


def mask_to_bbox(mask: np.ndarray):
    """Tight xywh bbox of the ``mask == 1`` region; all-zero -> [0,0,0,0]."""
    fg = mask == 1
    if not fg.any():
        return [0, 0, 0, 0]
    assert fg.ndim == 2
    rows = np.flatnonzero(fg.any(axis=1))
    cols = np.flatnonzero(fg.any(axis=0))
    y0, y1 = int(rows[0]), int(rows[-1])
    x0, x1 = int(cols[0]), int(cols[-1])
    return [x0, y0, x1 + 1 - x0, y1 + 1 - y0]


def bbox_iou(b1, b2) -> float:
    """IoU of two x1y1x2y2 boxes."""
    ix0 = max(b1[0], b2[0])
    ix1 = min(b1[2], b2[2])
    iy0 = max(b1[1], b2[1])
    iy1 = min(b1[3], b2[3])
    if ix1 <= ix0 or iy1 <= iy0:
        return 0.0
    inter = (ix1 - ix0) * (iy1 - iy0)
    a1 = float((b1[2] - b1[0]) * (b1[3] - b1[1]))
    a2 = float((b2[2] - b2[0]) * (b2[3] - b2[1]))
    return inter / (a1 + a2 - inter)


def crop_padding(img: np.ndarray, roi, pad_value) -> np.ndarray:
    """Crop ``roi`` (xywh, possibly out of bounds) from HxW[xC] ``img``,
    filling out-of-image area with ``pad_value`` (len == channels).

    Matches reference utils/data_utils.py:104-124 including its quirk of
    skipping the copy entirely when the roi has zero IoU with the image.
    """
    squeeze = img.ndim == 2
    if squeeze:
        img = img[:, :, None]
    assert len(pad_value) == img.shape[2]
    x, y, w, h = (int(v) for v in roi)
    H, W = img.shape[:2]
    out = np.empty((h, w, img.shape[2]), dtype=img.dtype)
    out[...] = np.asarray(pad_value, dtype=img.dtype)
    if bbox_iou((x, y, x + w, y + h), (0, 0, W, H)) > 0:
        out[max(-y, 0):min(H - y, h), max(-x, 0):min(W - x, w), :] = (
            img[max(y, 0):min(y + h, H), max(x, 0):min(x + w, W), :]
        )
    return out[:, :, 0] if squeeze else out


def pair_crop_bbox(bbox1, bbox2, shift_aug=None, scale_aug=None, rng=None):
    """The union-bbox "patch" crop used by every pair dataset and by eval
    pair preprocessing (reference occ_order_dataset.py:138-152,
    inference.py:360-365): center of the union box, square side
    max(sqrt(2*w*h), 1.1*w, 1.1*h), optional train-time shift/scale.

    Returns an int xywh roi for `crop_padding`.
    """
    bbox = combine_bbox(np.stack([np.asarray(bbox1), np.asarray(bbox2)]))
    cx = bbox[0] + bbox[2] / 2.0
    cy = bbox[1] + bbox[3] / 2.0
    size = max(np.sqrt(bbox[2] * bbox[3] * 2.0), bbox[2] * 1.1, bbox[3] * 1.1)
    if shift_aug is not None:
        cx += rng.uniform(*shift_aug) * size
        cy += rng.uniform(*shift_aug) * size
    if scale_aug is not None:
        size /= rng.uniform(*scale_aug)
    return [int(cx - size / 2.0), int(cy - size / 2.0), int(size), int(size)]


def _random_eraser_offsets(shape, min_overlap, max_overlap, rng):
    h, w = shape
    overlap = rng.uniform(min_overlap, max_overlap)
    offx = rng.uniform(overlap - 1, 1 - overlap)
    denom = (offx + 1) if offx < 0 else (1 - offx)
    over_y = overlap / denom
    offy = (over_y - 1) if rng.random() > 0.5 else (1 - over_y)
    assert -1 < offy < 1
    return offx, offy


def place_eraser(inst, eraser, min_overlap, max_overlap, rng=None):
    """Randomly shift ``eraser`` so its bbox-overlap with ``inst`` lies in
    [min_overlap, max_overlap]; returns (shifted eraser, pixel overlap ratio).
    """
    rng = np.random if rng is None else rng
    assert inst.ndim == 2 and eraser.ndim == 2
    assert min_overlap <= max_overlap
    h, w = inst.shape
    offx, offy = _random_eraser_offsets((h, w), min_overlap, max_overlap, rng)
    roi = (int(offx * w), int(offy * h), w, h)
    shifted = crop_padding(eraser, roi, pad_value=(0,))
    assert inst.max() <= 1 and shifted.max() <= 1
    ratio = ((inst == 1) & (shifted == 1)).sum() / float((inst == 1).sum() + 1e-5)
    return shifted, ratio


def place_eraser_in_ratio(inst, eraser, min_overlap, max_overlap,
                          min_ratio, max_ratio, max_iter, rng=None):
    """Retry `place_eraser` until the pixel cut ratio lands in range."""
    shifted = None
    for _ in range(max_iter):
        shifted, ratio = place_eraser(inst, eraser, min_overlap, max_overlap, rng)
        if min_ratio <= ratio < max_ratio:
            break
    return shifted

def scissor_mask(inst, eraser, min_overlap, max_overlap, rng=None):
    """Shift eraser over inst and zero the covered pixels.

    NOTE: keeps the reference's quirk of using ``h`` for the x-offset scale
    (utils/data_utils.py:183 — ``bbox = (int(offx * h), ...)``).
    """
    rng = np.random if rng is None else rng
    assert inst.ndim == 2 and eraser.ndim == 2
    assert min_overlap <= max_overlap
    h, w = inst.shape
    offx, offy = _random_eraser_offsets((h, w), min_overlap, max_overlap, rng)
    roi = (int(offx * h), int(offy * h), w, h)
    shifted = crop_padding(eraser, roi, pad_value=(0,)) > 0.5
    ratio = ((inst > 0.5) & shifted).sum() / float((inst > 0.5).sum())
    erased = inst.copy()
    erased[shifted] = 0
    return erased, shifted, ratio


def scissor_mask_force(inst, eraser, min_overlap, max_overlap,
                       min_ratio, max_ratio, max_iter, rng=None):
    erased, shifted = inst, eraser > 0.5
    for _ in range(max_iter):
        erased, shifted, ratio = scissor_mask(inst, eraser, min_overlap,
                                              max_overlap, rng)
        if min_ratio <= ratio < max_ratio:
            break
    return erased, shifted


def mask_aug(mask, config, rng=None):
    """Flip/scale aug of an uint8 mask (0/128/255), reference :199-213."""
    rng = np.random if rng is None else rng
    oldh, oldw = mask.shape
    if config['flip'] and rng.random() > 0.5:
        mask = mask[:, ::-1]
    lo, hi = config['scale']
    assert lo <= hi
    if not (lo == 1 and hi == 1):
        scale = rng.uniform(lo, hi)
        newh, neww = int(scale * oldh), int(scale * oldw)
        mask = resize_nearest_np(mask, newh, neww)
        roi = [(neww - oldw) // 2, (newh - oldh) // 2, oldw, oldh]
        mask = crop_padding(mask, roi, pad_value=(0,))
    return mask


def base_aug(img, scis_img, config, rng=None):
    """Joint flip/scale/shift aug of (mask, eraser), reference :216-235."""
    rng = np.random if rng is None else rng
    oldh, oldw = img.shape
    if config['flip'] and rng.random() > 0.5:
        img = img[:, ::-1]
        scis_img = scis_img[:, ::-1]
    lo, hi = config['scale']
    assert lo <= hi
    scale = rng.uniform(lo, hi)
    newh, neww = int(scale * oldh), int(scale * oldw)
    offx = int(oldw * rng.uniform(config['shift'][0], config['shift'][1]))
    offy = int(oldh * rng.uniform(config['shift'][0], config['shift'][1]))
    roi = [(neww - oldw) // 2 - offx, (newh - oldh) // 2 - offy, oldw, oldh]
    img = crop_padding(resize_nearest_np(img, newh, neww), roi,
                       pad_value=(0,))
    scis_img = crop_padding(resize_nearest_np(scis_img, newh, neww), roi,
                            pad_value=(0,))
    return img, scis_img


class EraserSetter:
    """Config-bound `place_eraser_in_ratio` (reference :238-249)."""

    def __init__(self, config):
        self.min_overlap = config['min_overlap']
        self.max_overlap = config['max_overlap']
        self.min_cut_ratio = config['min_cut_ratio']
        self.max_cut_ratio = config.get('max_cut_ratio', 1.0)

    def __call__(self, inst, eraser, rng=None):
        return place_eraser_in_ratio(inst, eraser, self.min_overlap,
                                     self.max_overlap, self.min_cut_ratio,
                                     self.max_cut_ratio, 100, rng)
