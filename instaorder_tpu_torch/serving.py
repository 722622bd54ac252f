"""The serving-d1 occlusion path: pair prep -> boundary-int8 ResNet-50 ->
sigmoid/threshold, one direction per pair.

Counterpart of the root bench.py megastep with the serving-d1 profile
(`--dtype int8 --directions 1`, fused 5-channel prep, 1-pass RGB):

  images (S, H, W, 3) + masks (S, N, H, W) + bboxes (S, N, 4)
    -> pair_rois -> fused prep kernel -> (S*P, 256, 256, 5) bf16
    -> apply_folded_v2 (bf16 stem conv, trunk kernels, f32 head)
    -> (S*P, 2) logits -> i_over_j, j_over_i decisions
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .eval.decode import decode_occ
from .models import quantize as Q
from .models import resnet
from .models.folding import fold_resnet
from .ops.pairs import build_pair_batches_fused, pair_rois


def synthetic_scenes(S, H=480, W=640, N=10, seed=0):
    """COCO-val-like synthetic scenes, drawn exactly as the root
    bench.py draws them: (images (S, H, W, 3) f32 in [0, 255), masks
    (S, N, H, W) f32 {0,1}, bboxes (S, N, 4) f32 xywh) as numpy."""
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 255, (S, H, W, 3)).astype(np.float32)
    masks = np.zeros((S, N, H, W), np.float32)
    bboxes = np.zeros((S, N, 4), np.float32)
    for s in range(S):
        for k in range(N):
            y0, x0 = rng.randint(0, H - 100), rng.randint(0, W - 100)
            hh, ww = rng.randint(30, 100, 2)
            masks[s, k, y0:y0 + hh, x0:x0 + ww] = 1
            bboxes[s, k] = [x0, y0, ww, hh]
    return images, masks, bboxes


def upload_scenes(images, masks, bboxes, device=None):
    """numpy scenes -> tensors on the device in the dtypes the prep
    kernel reads (images f32, masks uint8, bboxes f32)."""
    dev = resolve_device(device)
    return (torch.as_tensor(images, dtype=torch.float32, device=dev),
            torch.as_tensor(masks, device=dev).to(torch.uint8),
            torch.as_tensor(bboxes, dtype=torch.float32, device=dev))


def prep_pairs(images, masks, bboxes, pair_idx, out_size=256, passes=1):
    """(S*P, out, out, 5) bf16 pair batch for every pair of every scene."""
    rois = pair_rois(bboxes, pair_idx)
    return build_pair_batches_fused(images, masks, pair_idx, rois,
                                    out_size=out_size, passes=passes)


def build_serving_model(seed, calib_x, device=None, weight_init='xavier'):
    """InstaOrderNet_o for serving: a 5-channel ResNet-50 with a 2-logit
    occlusion head initialised from `seed`, BN-folded, calibrated in f32
    on the prepped batch `calib_x` (N, H, W, 5), then v2-quantized with
    bf16 weights. Returns (qparams, cfg).

    weight_init='xavier' (gain 0.02) is the root bench.py's model; its
    signal shrinks ~1e-12 through the trunk, below the 1e-8 scale floor,
    so every logit quantizes to 0. 'kaiming_out' (the torchvision
    constructor default) keeps the activations alive, which a check of
    the logits needs."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    params, stats, cfg = resnet.init(
        gen, arch='resnet50', in_channels=5, num_classes=2,
        weight_init=weight_init, device=dev)
    folded = fold_resnet(params, stats, cfg)
    scales = Q.calibrate_folded_resnet(folded, cfg,
                                       [calib_x.to(dev).float()])
    return Q.quantize_folded_v2(folded, cfg, scales), cfg


@torch.no_grad()
def megastep(q, cfg, images, masks, bboxes, pair_idx, out_size=256,
             passes=1):
    """One directions=1 serving step over S scenes. Returns (logits
    (S*P, 2) f32, i_over_j (S*P,) bool, j_over_i (S*P,) bool)."""
    x = prep_pairs(images, masks, bboxes, pair_idx, out_size=out_size,
                   passes=passes)
    logits = Q.apply_folded_v2(q, cfg, x)
    i_over_j, j_over_i = decode_occ(logits)
    return logits, i_over_j, j_over_i
