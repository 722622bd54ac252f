#!/usr/bin/env python
"""Throughput benchmark of the port's serving paths: pairs/sec on one GPU.

Mirrors the root bench.py, its profiles (serving.PROFILES) and its
--dtype (int8c, int8, bf16, f32; at f32 the folded model runs the f32
modes of the bf16 kernels and the prep writes f32): serving-d1
(the default: int8 v2 trunk, directions=1, fused 5-channel prep with
1-pass RGB), serving-d2 (the same v2 model, both directions, 3-pass
prep) and parity (the bf16 folded model, both directions, the cv2-exact
einsum prep). The same synthetic COCO-val-like scenes (480x640, 10
instances, 45 pairs each, np.random.RandomState(0)), the same step size
(1620 pairs), warm-up, windows and timing. Each window ends in
torch.cuda.synchronize(); the best window is reported.

    python -m instaorder_tpu_torch.bench [--profile serving-d1]
        [--dtype int8c|int8|bf16|f32] [--prep-rgb einsum|pallas|pallas5]
        [--pallas-features a,b,...] [--no-pallas] [--directions 1|2]
        [--prep-precision default|high|highest] [--prep-stage1 f32|bf16]
        [--pairs-per-step 1620]

Prints ONE JSON line:
  {"metric": "pairs/sec/chip", "value": N, "unit": "pairs/s",
   "vs_baseline": N / BASELINE_PAIRS_PER_S, "device": "<GPU name>",
   "profile": "...", "dtype": "...", "peak_mem_gb": G}
(peak_mem_gb: torch.cuda.max_memory_allocated over the timed steps; an
f32 step holds twice the bf16 activations). BASELINE_PAIRS_PER_S is this
bench's own --no-pallas rate at serving-d1 (the v2 model's chain of
cuDNN convolutions and PyTorch ops that the kernels replace, the prep
kernel kept): 3,519.2 pairs/s, the median of three runs on one NVIDIA
H100 80GB HBM3 at a 700.00 W power limit (3518.0, 3519.2, 3519.4).
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

# pairs/s of `--no-pallas` at serving-d1 on an H100 (module docstring)
BASELINE_PAIRS_PER_S = 3519.2


def add_profile_args(ap):
    """The profile flags (the root bench's meanings), shared with
    trace.py."""
    ap.add_argument('--profile', default='serving-d1',
                    choices=sorted(serving.PROFILES),
                    help='parity (bf16 swap ensemble), serving-d2 (v2, '
                         'both directions) or serving-d1 (v2, one '
                         'direction; the default)')
    ap.add_argument('--prep-rgb', default=None,
                    choices=['einsum', 'pallas', 'pallas5'],
                    help='prep route: einsum (dense f32 matmuls), pallas '
                         '(RGB kernel + exact mask matmuls) or pallas5 '
                         '(the 5-channel kernel); default from the profile')
    ap.add_argument('--dtype', default=None, choices=serving.DTYPES,
                    help='model: int8 (boundary-int8 v2, bf16 compute), '
                         'int8c (fully quantized int8 compute), bf16 or '
                         'f32 (the folded model; f32 is the accuracy-'
                         'parity route, its prep writes f32); default '
                         'from the profile')
    ap.add_argument('--directions', type=int, default=None, choices=[1, 2],
                    help='2 = the swap ensemble, 1 = one forward per pair; '
                         'default from the profile')
    ap.add_argument('--prep-precision', default=None,
                    choices=['default', 'high', 'highest'],
                    help='precision of the einsum prep\'s RGB matmuls '
                         '(highest f32, high the 3-pass bf16 split, '
                         'default 1-pass bf16); the kernel preps run '
                         '1-pass at default, else 3-pass; default from '
                         'the profile')
    ap.add_argument('--prep-stage1', default='f32', choices=['f32', 'bf16'],
                    help='storage dtype of the einsum prep\'s row-interp '
                         'intermediate (bf16 rounds it)')
    ap.add_argument('--no-pallas', action='store_true',
                    help='no kernel in the model (the prep route is set by '
                         '--prep-rgb alone)')
    ap.add_argument('--pallas-features', default=None,
                    help='comma list of kernel features, replacing the '
                         'default set of the model\'s dtype; every dtype '
                         'takes the root bench\'s names (identity, stage, '
                         'sstage, down, down1, down2, stem, stem2, qpool, '
                         'hwnc, hwncs, hwncs1, hwncs1d, hwncp, dirpack) '
                         'and ignores those it does not use. Defaults: '
                         'bf16 and f32 identity, int8 hwnc,down2,hwncs1d,'
                         'dirpack, int8c identity,down')


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
    add_profile_args(ap)
    return ap


def resolve(args):
    """serving.resolve_profile of the profile flags in `args`, with the
    prep precision beside it ('prep_precision')."""
    prof = serving.resolve_profile(
        args.profile, prep_rgb=args.prep_rgb, dtype=args.dtype,
        directions=args.directions, prep_precision=args.prep_precision)
    return dict(prof, prep_precision=serving.prep_precision_of(
        args.profile, args.prep_precision))


def use_pallas_of(args):
    """The model's kernel features: False with --no-pallas (the root
    bench.py's pure-XLA route; the prep route stays --prep-rgb's), else
    the --pallas-features names or True (the dtype's default set)."""
    if args.no_pallas:
        return False
    if args.pallas_features:
        return tuple(args.pallas_features.split(','))
    return True


def build_step(args, sc, pidx, out_size, dev):
    """The megastep of the profile flags in `args` over the uploaded
    scenes `sc`, as a no-argument function. int8 and int8c: the scales
    are calibrated on one prepped batch (f32 forward), then quantized
    (root bench.py --dtype int8: bf16 compute; --dtype int8c: int8
    compute); bf16: the folded model cast to bf16; f32: the folded
    model as it is."""
    prof = resolve(args)
    prep = dict(out_size=out_size, passes=prof['passes'],
                prep_rgb=prof['prep_rgb'],
                prep_precision=prof['prep_precision'],
                stage1_dtype=torch.bfloat16 if args.prep_stage1 == 'bf16'
                else None)
    kw = dict(prep, directions=prof['directions'],
              use_pallas=use_pallas_of(args))
    calib_x = None
    if prof['dtype'] in ('int8', 'int8c'):
        calib_x = serving.prep_pairs(*sc, pidx, **prep)
    q, cfg = serving.build_model(args.profile, 0, calib_x, device=dev,
                                 dtype=prof['dtype'])
    del calib_x
    return lambda: serving.megastep(q, cfg, *sc, pidx, **kw)


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
    step = build_step(args, sc, pidx, args.input_size, dev)

    for _ in range(args.warmup):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
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
        'vs_baseline': round(value / BASELINE_PAIRS_PER_S, 3),
        'device': torch.cuda.get_device_name(dev),
        'profile': args.profile,
        'dtype': resolve(args)['dtype'],
        'peak_mem_gb': torch.cuda.max_memory_allocated(dev) / 1e9,
    }))


if __name__ == '__main__':
    main()
