#!/usr/bin/env python
"""Throughput benchmark of the port's serving-d1 path: pairs/sec on one GPU.

Mirrors the root bench.py with its default serving-d1 profile (int8 v2
trunk, directions=1, fused 5-channel prep with 1-pass RGB): the same
synthetic COCO-val-like scenes (480x640, 10 instances, 45 pairs each,
np.random.RandomState(0)), the same step size (1620 pairs), warm-up,
windows and timing. Each window ends in torch.cuda.synchronize(); the
best window is reported.

    python -m instaorder_tpu_torch.bench [--pairs-per-step 1620]

Prints ONE JSON line:
  {"metric": "pairs/sec/chip", "value": N, "unit": "pairs/s",
   "vs_baseline": N / 10000, "device": "<GPU name>"}
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from . import serving
from .device import resolve_device
from .ops.pairs import all_pair_indices


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument('--pairs-per-step', type=int, default=1620)
    ap.add_argument('--input-size', type=int, default=256)
    ap.add_argument('--iters', type=int, default=20)
    ap.add_argument('--repeats', type=int, default=3,
                    help='measurement windows; best is reported')
    ap.add_argument('--warmup', type=int, default=3)
    ap.add_argument('--instances', type=int, default=10,
                    help='instances per synthetic scene (45 pairs at 10)')
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    dev = resolve_device()
    n = args.instances
    n_pairs_img = n * (n - 1) // 2
    S = max(1, int(np.ceil(args.pairs_per_step / n_pairs_img)))
    images, masks, bboxes = serving.synthetic_scenes(S, 480, 640, n, seed=0)
    sc = serving.upload_scenes(images, masks, bboxes, device=dev)
    pair_idx, _ = all_pair_indices(n)
    pidx = torch.as_tensor(pair_idx, dtype=torch.int32, device=dev)
    sz = args.input_size

    # PTQ: calibrate the boundary scales on one prepped batch (f32
    # forward), then quantize with bf16 compute (root bench.py --dtype int8)
    calib_x = serving.prep_pairs(*sc, pidx, out_size=sz, passes=1)
    q, cfg = serving.build_serving_model(0, calib_x, device=dev)
    del calib_x

    def step():
        return serving.megastep(q, cfg, *sc, pidx, out_size=sz, passes=1)

    for _ in range(args.warmup):
        step()
    torch.cuda.synchronize()
    best = float('inf')
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        for _ in range(args.iters):
            step()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    value = S * n_pairs_img * args.iters / best
    print(json.dumps({
        'metric': 'pairs/sec/chip',
        'value': round(value, 1),
        'unit': 'pairs/s',
        'vs_baseline': round(value / 10000.0, 3),
        'device': torch.cuda.get_device_name(dev),
    }))


if __name__ == '__main__':
    main()
