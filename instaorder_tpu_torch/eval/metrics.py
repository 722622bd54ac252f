"""Evaluation metrics — R/P/F1, WHDR, pairwise accuracy, dense depth
(counterpart of instaorder_tpu/eval/metrics.py, copied whole).

Numpy implementations matching the reference exactly:
  eval_order                      <- inference.py:742-754
  eval_order_recall_precision_f1  <- inference.py:794-802 (sklearn binary)
  calculate_whdr / eval_depth_order_whdr <- inference.py:757-791
  compute_errors (dense depth)    <- tools/test_disp_KITTI.py:125-145
  compute_scale_and_shift         <- tools/test_disp_KITTI.py:147-169
"""

from __future__ import annotations

import collections

import numpy as np


def extract_upper_tri(a: np.ndarray) -> np.ndarray:
    return a[np.triu_indices_from(a, k=1)]


def eval_order(order_matrix, gt_order_matrix):
    """Pairwise accuracy counts (allpair/occpair true totals + error list)."""
    n = order_matrix.shape[0]
    eq = order_matrix == gt_order_matrix
    allpair_true = (eq.sum() - n) / 2
    allpair = (n * n - n) / 2
    occpair_true = (eq & (gt_order_matrix != 0)).sum() / 2
    occpair = (gt_order_matrix != 0).sum() / 2
    err = np.where(~eq)
    show_err = np.concatenate(
        [np.array(err).T + 1,
         gt_order_matrix[err][:, None], order_matrix[err][:, None]], axis=1)
    return allpair_true, allpair, occpair_true, occpair, show_err


def _binary_score(tp, denom, zero_division):
    if denom == 0:
        return float(zero_division)
    return tp / denom


def eval_order_recall_precision_f1(order_matrix, gt_order_matrix, zd=0):
    """Binary recall/precision/F1 over matrix entries != -1, x100
    (sklearn `average='binary'` semantics with zero_division=zd)."""
    keep = gt_order_matrix != -1
    gt = np.asarray(gt_order_matrix)[keep].reshape(-1)
    pred = np.asarray(order_matrix)[keep].reshape(-1)
    tp = int(((gt == 1) & (pred == 1)).sum())
    recall = _binary_score(tp, int((gt == 1).sum()), zd)
    precision = _binary_score(tp, int((pred == 1).sum()), zd)
    if precision + recall == 0:
        f1 = float(zd) if (int((gt == 1).sum()) == 0 and
                           int((pred == 1).sum()) == 0) else 0.0
    else:
        f1 = 2 * precision * recall / (precision + recall)
    return recall * 100, precision * 100, f1 * 100


def calculate_whdr(order, gt_order, score, mask):
    if mask.sum() == 0:
        return -1
    w = score[mask]
    return ((gt_order[mask] != order[mask]) * w).sum() / w.sum() * 100


def eval_depth_order_whdr(order_matrix, gt_order_ovl_count):
    """WHDR sliced by overlap {ovlX, ovlO, ovlOX} x equality {eq, neq, all};
    weight = 2 / annotator count. Returns dict[str, [whdr]] exactly like
    the reference's defaultdict-of-lists."""
    gt_order, gt_overlap, gt_count = gt_order_ovl_count
    gt_order = extract_upper_tri(np.asarray(gt_order))
    gt_overlap = extract_upper_tri(np.asarray(gt_overlap))
    gt_count = extract_upper_tri(np.asarray(gt_count))
    order = extract_upper_tri(np.asarray(order_matrix))
    with np.errstate(divide='ignore'):
        score = 2.0 / gt_count

    mask_ovls = {
        'ovlX': gt_overlap == 0,
        'ovlO': gt_overlap == 1,
    }
    mask_ovls['ovlOX'] = mask_ovls['ovlX'] | mask_ovls['ovlO']
    mask_eqs = {
        'eq': gt_order == 2,
        'neq': (gt_order == 0) | (gt_order == 1),
    }
    mask_eqs['all'] = mask_eqs['eq'] | mask_eqs['neq']

    out = collections.defaultdict(list)
    for ko, mo in mask_ovls.items():
        for ke, me in mask_eqs.items():
            out[f'{ko}_{ke}'].append(
                calculate_whdr(order, gt_order, score, mo & me))
    return out


def compute_errors(gt, pred):
    """8 dense-depth metrics (KITTI/NYU eval), reference
    tools/test_disp_KITTI.py:125-145."""
    thresh = np.maximum(gt / pred, pred / gt)
    d1 = (thresh < 1.25).mean()
    d2 = (thresh < 1.25 ** 2).mean()
    d3 = (thresh < 1.25 ** 3).mean()
    rms = np.sqrt(((gt - pred) ** 2).mean())
    log_rms = np.sqrt(((np.log(gt) - np.log(pred)) ** 2).mean())
    abs_rel = (np.abs(gt - pred) / gt).mean()
    sq_rel = (((gt - pred) ** 2) / gt).mean()
    err = np.log(pred) - np.log(gt)
    silog = np.sqrt((err ** 2).mean() - err.mean() ** 2) * 100
    return dict(abs_rel=abs_rel, sq_rel=sq_rel, rmse=rms, rmse_log=log_rms,
                d1=d1, d2=d2, d3=d3, silog=silog)


def compute_scale_and_shift(prediction, target, mask):
    """Closed-form LSQ scale/shift aligning disparity to GT
    (tools/test_disp_KITTI.py:147-169)."""
    m = mask.astype(np.float64)
    a00 = (m * prediction * prediction).sum()
    a01 = (m * prediction).sum()
    a11 = m.sum()
    b0 = (m * prediction * target).sum()
    b1 = (m * target).sum()
    det = a00 * a11 - a01 * a01
    if det <= 0:
        return 0.0, 0.0
    scale = (a11 * b0 - a01 * b1) / det
    shift = (-a01 * b0 + a00 * b1) / det
    return scale, shift


def diw_whdr_update(disp, a_yx, b_yx, ordinal):
    """Single DIW sample: is the predicted ordinal relation wrong?
    (tools/test_disp_DIW.py:137-168). disp: (H, W) upsampled to the
    original image size; ordinal in {'>', '<'} meaning A closer/farther."""
    da = disp[a_yx[0], a_yx[1]]
    db = disp[b_yx[0], b_yx[1]]
    # larger disparity = closer. ordinal '>': A closer than B.
    pred = '>' if da > db else '<'
    return pred != ordinal


def accuracy_topk(output, target, topk=(1,)):
    """precision@k (reference utils/common_utils.py:112-125)."""
    output = np.asarray(output)
    target = np.asarray(target)
    maxk = max(topk)
    n = target.shape[0]
    pred = np.argsort(-output, axis=1)[:, :maxk]
    correct = pred == target[:, None]
    return [float(correct[:, :k].sum()) * 100.0 / n for k in topk]
