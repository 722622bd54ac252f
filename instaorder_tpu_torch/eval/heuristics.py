"""Heuristic order baselines (no learned model; counterpart of
instaorder_tpu/eval/heuristics.py).

Parity targets in the reference:
  infer_occ_order_area / _yaxis    <- inference.py:272-307
  infer_depth_order_area / _yaxis  <- inference.py:310-346
  infer_order_hull                 <- inference.py:254-269
  infer_gt_order (KINS GT derivation) <- inference.py:719-739

area/yaxis are host-side numpy loops; the bordering test is the port's
batched `ops/morphology.bordering_matrix` on a tensor on `device` (None:
the card, through `device.resolve_device`; 'cpu' for the tests), whose
overlap counts are exact in float64, so the result does not depend on
the device. The convex-hull baseline stays on the host
(scipy.spatial.ConvexHull; not a hot path).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops.morphology import bordering_matrix


def _bordering_np(masks, device=None):
    t = torch.as_tensor(np.asarray(masks),
                        device=resolve_device(device)).to(torch.uint8)
    return bordering_matrix(t).cpu().numpy()


def infer_occ_order_area(inmodal, occluder='smaller', device=None):
    """Bordering pairs only: the smaller (or bigger) mask occludes."""
    n = inmodal.shape[0]
    order = np.zeros((n, n), int)
    border = _bordering_np(inmodal, device)
    areas = inmodal.reshape(n, -1).sum(axis=1)
    for i in range(n):
        for j in range(i + 1, n):
            if not border[i, j]:
                continue
            small, big = (i, j) if areas[i] < areas[j] else (j, i)
            if occluder == 'smaller':
                order[small, big] = 1
            else:
                order[big, small] = 1
    return order


def infer_occ_order_yaxis(inmodal, occluder='lower', device=None):
    """Bordering pairs only: mask with lower centroid occludes.
    NB the reference names the *smaller-y* centroid 'lower' here
    (inference.py:301: lower, higher = (i, j) if center_i[0] < center_j[0]);
    kept bit-identical."""
    n = inmodal.shape[0]
    order = np.zeros((n, n), int)
    border = _bordering_np(inmodal, device)
    cy = [np.where(inmodal[k] == 1)[0].mean() if inmodal[k].any() else 0.0
          for k in range(n)]
    for i in range(n):
        for j in range(i + 1, n):
            if not border[i, j]:
                continue
            lower, higher = (i, j) if cy[i] < cy[j] else (j, i)
            if occluder == 'lower':
                order[lower, higher] = 1
            else:
                order[higher, lower] = 1
    return order


def infer_depth_order_area(inmodal, closer='smaller'):
    """All pairs: smaller (or bigger) area is closer."""
    n = inmodal.shape[0]
    order = np.zeros((n, n), int)
    areas = inmodal.reshape(n, -1).sum(axis=1)
    for i in range(n):
        for j in range(i + 1, n):
            small, big = (i, j) if areas[i] < areas[j] else (j, i)
            if closer == 'smaller':
                order[small, big] = 1
            else:
                order[big, small] = 1
    return order


def infer_depth_order_yaxis(inmodal, closer='lower'):
    """All pairs; note the reference swaps the tuple order vs the occ
    variant (inference.py:340: higher, lower = ... if cy_i < cy_j)."""
    n = inmodal.shape[0]
    order = np.zeros((n, n), int)
    cy = [np.where(inmodal[k] == 1)[0].mean() if inmodal[k].any() else 0.0
          for k in range(n)]
    for i in range(n):
        for j in range(i + 1, n):
            higher, lower = (i, j) if cy[i] < cy[j] else (j, i)
            if closer == 'lower':
                order[lower, higher] = 1
            else:
                order[higher, lower] = 1
    return order


def convex_hull_image(mask):
    """Filled convex hull of a binary mask (skimage-equivalent up to
    half-pixel boundary handling; skimage isn't vendored in this image).
    Uses pixel corners like skimage's default so the hull covers the mask.
    """
    from scipy.spatial import ConvexHull, QhullError
    ys, xs = np.nonzero(mask)
    if len(ys) == 0:
        return np.zeros_like(mask, dtype=bool)
    # pixel corners: each pixel contributes its 4 corners
    pts = np.concatenate([
        np.stack([ys - 0.5, xs - 0.5], 1), np.stack([ys - 0.5, xs + 0.5], 1),
        np.stack([ys + 0.5, xs - 0.5], 1), np.stack([ys + 0.5, xs + 0.5], 1),
    ])
    try:
        hull = ConvexHull(pts)
    except QhullError:
        return mask.astype(bool)
    h, w = mask.shape
    gy, gx = np.mgrid[0:h, 0:w]
    grid = np.stack([gy.ravel(), gx.ravel(), np.ones(h * w)], axis=1)
    inside = (grid @ hull.equations.T <= 1e-9).all(axis=1)
    return inside.reshape(h, w)


def infer_order_hull(inmodal):
    """Convex-hull occlusion heuristic: hull-minus-modal overlap votes
    (inference.py:254-269; note its output convention is -1/1)."""
    n = inmodal.shape[0]
    occ_value = np.zeros((n, n), np.float32)
    hulls = [convex_hull_image(m) if m.any() else m.astype(bool)
             for m in inmodal]
    for i in range(n):
        for j in range(i + 1, n):
            occ_value[i, j] = ((hulls[i] > inmodal[i].astype(bool))
                               & (inmodal[j] == 1)).sum()
            occ_value[j, i] = ((hulls[j] > inmodal[j].astype(bool))
                               & (inmodal[i] == 1)).sum()
    order = np.zeros((n, n), int)
    order[occ_value > occ_value.T] = -1
    order[occ_value < occ_value.T] = 1
    order[(occ_value == 0) & (occ_value == 0).T] = 0
    return order


def infer_gt_order(inmodal, amodal, device=None):
    """Derive GT occlusion order from modal/amodal overlap (KINS path,
    inference.py:719-739)."""
    n = inmodal.shape[0]
    gt = np.zeros((n, n), int)
    border = _bordering_np(inmodal, device)
    for i in range(n):
        for j in range(i + 1, n):
            if not border[i, j]:
                continue
            occ_ij = int(((inmodal[i] == 1) & (amodal[j] == 1)).sum())
            occ_ji = int(((inmodal[j] == 1) & (amodal[i] == 1)).sum())
            if occ_ij == 0 and occ_ji == 0:
                continue
            if occ_ij >= occ_ji:
                gt[i, j], gt[j, i] = 1, 0
            else:
                gt[i, j], gt[j, i] = 0, 1
    return gt
