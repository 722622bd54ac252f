"""Binary morphology for the `nbor` pair filter and InstaDepthNet's
order loss (counterpart of instaorder_tpu/ops/morphology.py:
`binary_erosion`, `binary_dilation`, `bordering_matrix`).

The 4-connected cross structuring element is five shifted copies;
out-of-image is 0 (scipy.ndimage.binary_erosion's default border_value;
dilating a binary mask with a replicated edge gives the same result, since
the identity term already holds the edge pixel).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _shift(x, dy: int, dx: int):
    """Shift the trailing 2 dims of a bool tensor by (dy, dx), filling the
    vacated area with False."""
    h, w = x.shape[-2], x.shape[-1]
    xp = F.pad(x.to(torch.uint8), (max(dx, 0), max(-dx, 0),
                                   max(dy, 0), max(-dy, 0)))
    ys = slice(0, h) if dy >= 0 else slice(-dy, h - dy)
    xs = slice(0, w) if dx >= 0 else slice(-dx, w - dx)
    return xp[..., ys, xs].bool()


def binary_erosion(mask):
    """4-connected erosion of a (..., H, W) boolean mask, border value 0:
    scipy.ndimage.binary_erosion with its default structure (the
    reference erodes on the host, models/supervised_order.py:160-164)."""
    m = mask.bool()
    out = m
    for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        out = out & _shift(m, dy, dx)
    return out


def binary_dilation(mask):
    """4-connected dilation of a (..., H, W) boolean mask."""
    m = mask.bool()
    out = m
    for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        out = out | _shift(m, dy, dx)
    return out


def bordering_matrix(masks):
    """(N, H, W) instance masks -> (N, N) bool: do i and j touch?
    bordering(i, j) := any(dilate(mask_i) & mask_j), the diagonal False.
    The (N, HW) x (HW, N) overlap count runs in float64, where every
    count is exact (no TF32 or bf16 rounding can turn a single touching
    pixel into 0)."""
    n = masks.shape[0]
    d = binary_dilation(masks).reshape(n, -1).double()
    m = masks.reshape(n, -1).bool().double()
    touch = (d @ m.T) > 0
    return touch & ~torch.eye(n, dtype=torch.bool, device=masks.device)
