"""Dense CRF mean-field refinement (counterpart of instaorder_tpu/ops/crf.py,
copied whole: numpy / scipy on the host) — replaces pydensecrf for the
instseg branch (reference utils/common_utils.py:169-177 +
inference.py:849-853).

The reference builds a DenseCRF2D with
  addPairwiseGaussian(sxy=3, compat=3)
  addPairwiseBilateral(sxy=80, srgb=13, rgbim=rgb, compat=10)
and runs `inference(1)`. Mean-field step (Kraehenbuehl & Koltun, NIPS'11;
densecrf stepInference with Potts compatibility):

  Q <- softmax(-U + sum_m w_m * k_norm_m (x) Q)

where U = -log(prob), k_norm is the symmetrically-normalized kernel
(pydensecrf's default NORMALIZE_SYMMETRIC: y = K(x/sqrt(n))/sqrt(n),
n = K(1)). The spatial Gaussian kernel is computed exactly (separable
convolution); the bilateral kernel uses a 5-D bilateral grid (Chen et
al.), the same family of lattice approximation pydensecrf's
permutohedral filter uses — behavioral parity, not bit parity.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage


def _normalized(filt, values):
    """Symmetric kernel normalization over an (..., C) value array."""
    ones = np.ones(values.shape[:-1] + (1,), values.dtype)
    norm = filt(ones)
    norm = 1.0 / np.sqrt(np.maximum(norm, 1e-20))
    return filt(values * norm) * norm


def _gaussian_spatial(values, sxy):
    """Exact Gaussian spatial filter over (H, W, C)."""
    return ndimage.gaussian_filter(
        values, sigma=(sxy, sxy, 0), mode='constant', truncate=4.0)


def _bilateral_grid(values, rgb, sxy, srgb):
    """Approximate Gaussian bilateral filter of (H, W, C) guided by
    (H, W, 3) rgb via a 5-D bilateral grid with unit-sigma blur."""
    h, w, c = values.shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    feat = np.stack([yy / sxy, xx / sxy,
                     rgb[..., 0] / srgb, rgb[..., 1] / srgb,
                     rgb[..., 2] / srgb], axis=-1).reshape(-1, 5)
    lo = feat.min(axis=0)
    idx = np.rint(feat - lo).astype(np.int64) + 1
    dims = tuple(idx.max(axis=0) + 2)
    grid = np.zeros(dims + (c,), np.float64)
    np.add.at(grid, tuple(idx.T), values.reshape(-1, c))
    grid = ndimage.gaussian_filter(
        grid, sigma=(1, 1, 1, 1, 1, 0), mode='constant', truncate=3.0)
    out = grid[tuple(idx.T)]
    return out.reshape(h, w, c)


def densecrf(prob, rgb, iters=1, sxy_gaussian=3, compat_gaussian=3,
             sxy_bilateral=80, srgb=13, compat_bilateral=10):
    """prob: (C, H, W) class probabilities; rgb: (H, W, 3) uint8 image.
    Returns refined (C, H, W) probabilities after `iters` mean-field
    steps — drop-in for reference utils/common_utils.py:densecrf."""
    prob = np.asarray(prob, np.float64)
    rgb = np.asarray(rgb, np.float64)
    c = prob.shape[0]
    q = prob.transpose(1, 2, 0)  # HWC
    unary = -np.log(np.clip(q, 1e-20, None))

    def gauss(v):
        return _gaussian_spatial(v, sxy_gaussian)

    def bilat(v):
        return _bilateral_grid(v, rgb, sxy_bilateral, srgb)

    for _ in range(iters):
        msg = (compat_gaussian * _normalized(gauss, q) +
               compat_bilateral * _normalized(bilat, q))
        logits = -unary + msg
        logits -= logits.max(axis=-1, keepdims=True)
        e = np.exp(logits)
        q = e / e.sum(axis=-1, keepdims=True)
    assert q.shape[-1] == c
    return np.ascontiguousarray(q.transpose(2, 0, 1))
