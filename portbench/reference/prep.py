"""The plain reference of the inputs and outputs around the nets: pair
crops, the shared resize, the ImageNet normalisation, and the decode of
logits into order matrices.

Semantics are OpenCV's, as the InstaOrder reference uses it: a pair's
crop is the square around the union of its two boxes, padded with 0
outside the image, resized with INTER_CUBIC (A = -0.75, half-pixel
centres, taps clamped to the crop window) for RGB and INTER_NEAREST
(floor mapping) for the masks; a whole-image resize clamps its taps to
the image (BORDER_REPLICATE); the uint8 result is rounded and saturated
before the float conversion.

`pair_batch` writes the serving route's RGB at its stated precision,
one pass: the interpolation weights and the row-interpolated values in
bf16, every sum in f32.
"""

from __future__ import annotations

import numpy as np
import torch

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def normalize(rgb):
    mean = torch.tensor(MEAN, device=rgb.device)
    std = torch.tensor(STD, device=rgb.device)
    return (rgb / 255.0 - mean) / std


def cubic(t, A=-0.75):
    at = t.abs()
    inner = ((A + 2.0) * at - (A + 3.0)) * at * at + 1.0
    outer = ((A * at - 5.0 * A) * at + 8.0 * A) * at - 4.0 * A
    zero = torch.zeros((), dtype=t.dtype, device=t.device)
    return torch.where(at <= 1.0, inner, torch.where(at < 2.0, outer, zero))


def pair_rois(bboxes, pairs):
    """bboxes (N, 4) xywh, pairs (P, 2) -> (P, 4) square rois [x, y, s, s]:
    side max(sqrt(2 w h), 1.1 w, 1.1 h) of the union box, centred on it,
    each value truncated toward 0."""
    pairs = torch.as_tensor(pairs, dtype=torch.long, device=bboxes.device)
    b1, b2 = bboxes[pairs[:, 0]], bboxes[pairs[:, 1]]
    left = torch.minimum(b1[:, 0], b2[:, 0])
    top = torch.minimum(b1[:, 1], b2[:, 1])
    right = torch.maximum(b1[:, 0] + b1[:, 2], b2[:, 0] + b2[:, 2])
    bottom = torch.maximum(b1[:, 1] + b1[:, 3], b2[:, 1] + b2[:, 3])
    w, h = right - left, bottom - top
    size = torch.maximum(torch.sqrt(w * h * 2.0),
                         torch.maximum(w * 1.1, h * 1.1))
    x = torch.trunc(left + w / 2.0 - size / 2.0)
    y = torch.trunc(top + h / 2.0 - size / 2.0)
    s = torch.trunc(size)
    return torch.stack([x, y, s, s], dim=-1)


def _crop_matrix(off, size, out, src, method):
    """(P, out, src) interpolation matrix of one axis of crop windows
    [off, off + size): taps clamped to the window, zero outside the
    image. Built from the taps, the window's clamped taps accumulated
    on its edge pixels."""
    P = off.shape[0]
    d = torch.arange(out, dtype=torch.float32, device=off.device)
    m = torch.zeros((P, out, src), dtype=torch.float32, device=off.device)
    rows = torch.arange(out, device=off.device)[None, :].expand(P, out)
    pidx = torch.arange(P, device=off.device)[:, None].expand(P, out)
    size_ = size[:, None]
    if method == 'nearest':
        t = torch.floor(d[None] * size_ / out)
        t = torch.minimum(torch.clamp(t, min=0.0), size_ - 1.0)
        taps, wts = [t], [torch.ones_like(t)]
    else:
        f = (d[None] + 0.5) * size_ / out - 0.5
        x0 = torch.floor(f)
        taps, wts = [], []
        for k in (-1, 0, 1, 2):
            t = torch.minimum(torch.clamp(x0 + k, min=0.0), size_ - 1.0)
            taps.append(t)
            wts.append(cubic(k - (f - x0)))
    for t, w in zip(taps, wts):
        s = t + off[:, None]
        inside = (s >= 0) & (s <= src - 1)
        col = torch.clamp(s, 0, src - 1).long()
        m.index_put_((pidx, rows, col), w * inside, accumulate=True)
    return m


def _bf(x):
    return x.to(torch.bfloat16).float()


def pair_batch(image, masks, pairs, rois, out=256):
    """One scene's pair batch (P, out, out, 5) f32 [mask_i, mask_j,
    normalised RGB]: image (H, W, 3) raw [0, 255], masks (N, H, W) {0, 1},
    pairs (P, 2), rois (P, 4). RGB one pass: the x-axis interpolation
    (bf16 weights) of the image rows, the result in bf16, then the y
    axis (bf16 weights), f32 sums."""
    H, W, _ = image.shape
    wx = _crop_matrix(rois[:, 0], rois[:, 2], out, W, 'cubic')
    wy = _crop_matrix(rois[:, 1], rois[:, 3], out, H, 'cubic')
    img = image.float()
    rows = _bf(torch.einsum('pjw,hwc->phjc', _bf(wx), _bf(img)))
    rgb = torch.einsum('pih,phjc->pijc', _bf(wy), rows)
    rgb = normalize(torch.clamp(torch.round(rgb), 0.0, 255.0))
    nx = _crop_matrix(rois[:, 0], rois[:, 2], out, W, 'nearest')
    ny = _crop_matrix(rois[:, 1], rois[:, 3], out, H, 'nearest')
    pairs = torch.as_tensor(pairs, dtype=torch.long, device=image.device)
    m = masks.float()[pairs]                          # (P, 2, H, W)
    m = torch.einsum('pih,pkhw,pjw->pijk', ny, m, nx)
    return torch.cat([m, rgb], dim=-1)


def resize_matrix(src, dst, method):
    """(dst, src) matrix of a whole-axis resize, taps clamped to the
    image: 'cubic' or 'nearest'."""
    if method == 'nearest':
        idx = np.minimum(np.floor(np.arange(dst) * (src / dst)).astype(int),
                         src - 1)
        m = np.zeros((dst, src), np.float32)
        m[np.arange(dst), idx] = 1.0
        return torch.from_numpy(m)
    f = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    x0 = np.floor(f).astype(np.int64)
    t = f - x0
    m = np.zeros((dst, src), np.float32)
    for k in range(-1, 3):
        w = cubic(torch.from_numpy(k - t)).numpy().astype(np.float32)
        np.add.at(m, (np.arange(dst), np.clip(x0 + k, 0, src - 1)), w)
    return torch.from_numpy(m)


def shared_batch(image, masks, pairs, out=384):
    """The resize mode's pair batch (P, out, out, 5) f32: one cubic resize
    of the whole image, the masks resized nearest, for each pair
    [mask_i, mask_j, RGB]."""
    H, W, _ = image.shape
    dev = image.device
    ry, rx = (resize_matrix(H, out, 'cubic').to(dev),
              resize_matrix(W, out, 'cubic').to(dev))
    rgb = torch.einsum('Yh,hwc,Xw->YXc', ry, image.float(), rx)
    rgb = normalize(torch.clamp(torch.round(rgb), 0.0, 255.0))
    ny, nx = (resize_matrix(H, out, 'nearest').to(dev),
              resize_matrix(W, out, 'nearest').to(dev))
    m = torch.einsum('Yh,nhw,Xw->nYX', ny, masks.float(), nx)
    pairs = torch.as_tensor(pairs, dtype=torch.long, device=dev)
    P = pairs.shape[0]
    return torch.cat([m[pairs[:, 0], ..., None], m[pairs[:, 1], ..., None],
                      rgb[None].expand(P, out, out, 3)], dim=-1)


def swap_masks(x):
    return x[..., [1, 0, 2, 3, 4]]


def upper_pairs(n):
    return np.array([(i, j) for i in range(n) for j in range(i + 1, n)],
                    np.int64).reshape(-1, 2)


def occ_probs(o1, o2=None):
    """(p_i_over_j, p_j_over_i): column 1 of a direction's logits is
    "i over j", column 0 "j over i"; two directions are averaged, the
    swapped one's columns exchanged."""
    s1 = torch.sigmoid(o1)
    if o2 is None:
        return s1[:, 1], s1[:, 0]
    s2 = torch.sigmoid(o2)
    return (s1[:, 1] + s2[:, 0]) / 2.0, (s1[:, 0] + s2[:, 1]) / 2.0


def depth_probs(d1, d2):
    """(P, 3) averaged (closer, farther, equal) of both directions."""
    s1, s2 = torch.softmax(d1, -1), torch.softmax(d2, -1)
    return torch.stack([(s1[:, 0] + s2[:, 1]) / 2.0,
                        (s1[:, 1] + s2[:, 0]) / 2.0,
                        (s1[:, 2] + s2[:, 2]) / 2.0], dim=1)


def matrices(n, pairs, p_ij, p_ji, dprob):
    """The (N, N) occlusion and depth matrices: occ[i, j] = 1 iff i is
    over j; depth closer [i, j] = 1, farther [j, i] = 1, equal both 2."""
    occ = np.zeros((n, n), np.int32)
    dep = np.zeros((n, n), np.int32)
    arg = dprob.argmax(1).cpu().numpy()
    pij, pji = (p_ij > 0.5).cpu().numpy(), (p_ji > 0.5).cpu().numpy()
    for k, (i, j) in enumerate(pairs):
        occ[i, j], occ[j, i] = int(pij[k]), int(pji[k])
        a = arg[k]
        dep[i, j] = 1 if a == 0 else (2 if a == 2 else 0)
        dep[j, i] = 1 if a == 1 else (2 if a == 2 else 0)
    return occ, dep
