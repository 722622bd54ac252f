"""The one traffic generator: scenes, images and training batches drawn
from the run's seed by the parameters of a mix's data file
(`portbench/traffic/<mix>.json`). Pixels are uniform noise in [0, 255)
and instances axis-aligned rectangles (their boxes exact), as the
port's own synthetic scenes; sizes and counts come from the mix file,
so every seed gets the same work and only the draws differ.
"""

from __future__ import annotations

import numpy as np
import torch

from .weights import generator, subseed


def _rects(rng, shape, H, W, lo, hi):
    """Boxes (..., 4) xywh with sides in [lo, hi) inside an H x W image."""
    hh = rng.integers(lo, hi, shape)
    ww = rng.integers(lo, hi, shape)
    y0 = rng.integers(0, H - hh)
    x0 = rng.integers(0, W - ww)
    return np.stack([x0, y0, ww, hh], axis=-1).astype(np.float32)


def _paint(boxes, H, W, device):
    """(..., N, H, W) uint8 masks of the boxes (..., N, 4) xywh."""
    b = torch.as_tensor(boxes, device=device)[..., None, None]
    yy = torch.arange(H, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(W, device=device, dtype=torch.float32)[None, :]
    inside = ((yy >= b[..., 1, :, :]) & (yy < b[..., 1, :, :] + b[..., 3, :, :])
              & (xx >= b[..., 0, :, :]) & (xx < b[..., 0, :, :] + b[..., 2, :, :]))
    return inside.to(torch.uint8)


def scenes(seed, tag, n, mix, device):
    """n scenes of mix['instances'] rectangles on mix['height'] x
    mix['width'] noise: images (n, H, W, 3) f32, masks (n, N, H, W)
    uint8, bboxes (n, N, 4) f32, on `device`."""
    H, W, N = mix['height'], mix['width'], mix['instances']
    rng = np.random.default_rng(subseed(seed, tag))
    boxes = _rects(rng, (n, N), H, W, mix['box_min'], mix['box_max'])
    g = generator(seed, tag, device)
    images = torch.randint(0, 255, (n, H, W, 3), generator=g, device=device,
                           dtype=torch.float32)
    return images, _paint(boxes, H, W, device), torch.as_tensor(
        boxes, device=device)


def images(seed, tag, counts, mix, device):
    """One image per instance count in `counts` (numpy, the per-image
    API's inputs): a list of (image (H, W, 3) f32, masks (N, H, W)
    uint8, bboxes (N, 4) f32)."""
    H, W = mix['height'], mix['width']
    rng = np.random.default_rng(subseed(seed, tag))
    g = generator(seed, tag, device)
    out = []
    for n in counts:
        boxes = _rects(rng, (n,), H, W, mix['box_min'], mix['box_max'])
        img = torch.randint(0, 255, (H, W, 3), generator=g, device=device,
                            dtype=torch.float32)
        out.append((img.cpu().numpy(), _paint(boxes, H, W, device).cpu()
                    .numpy(), boxes))
    return out


def train_batches(seed, rank, mix, device, count, batch):
    """The first `count` of a rank's pool of training batches of `batch`
    pairs, from the seed and the rank: rgb normalised (N, S, S, 3), modal1 / modal2
    (N, S, S) f32 {0, 1}, occ_order (N, 2) f32 {0, 1}, depth_order (N,)
    in {0, 1, 2}, is_overlap (N,) in {0, 1}."""
    S, B, k = mix['size'], batch, count
    rng = np.random.default_rng(subseed(seed, 100 + rank))
    g = generator(seed, 100 + rank, device)
    mean = torch.tensor((0.485, 0.456, 0.406), device=device)
    std = torch.tensor((0.229, 0.224, 0.225), device=device)
    out = []
    for _ in range(k):
        boxes = _rects(rng, (B, 2), S, S, mix['box_min'], mix['box_max'])
        m = _paint(boxes, S, S, device).float()
        rgb = torch.randint(0, 255, (B, S, S, 3), generator=g, device=device,
                            dtype=torch.float32)
        out.append({
            'rgb': (rgb / 255.0 - mean) / std,
            'modal1': m[:, 0].contiguous(), 'modal2': m[:, 1].contiguous(),
            'occ_order': torch.randint(0, 2, (B, 2), generator=g,
                                       device=device).float(),
            'depth_order': torch.randint(0, 3, (B,), generator=g,
                                         device=device),
            'is_overlap': torch.randint(0, 2, (B,), generator=g,
                                        device=device)})
    return out
