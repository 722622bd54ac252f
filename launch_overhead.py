#!/usr/bin/env python3
"""Host time of the kernel wrappers' launches and of the serving
predictors that make them, for the tree at --root (default: this one),
so that two trees can be compared in one run on one card:

    python3 launch_overhead.py [--root DIR] [--calls 2000] [--reps 21]

(1) us a call on the host: `fused_prep_rgb` (ops/prep_kernels.py) on a
tiny input (one 16 x 16 crop of a 32 x 32 image; the card keeps up, so
the host's time is the wrapper's), beside the same library entry point
called through ctypes directly with the same arguments (the wrapper's
own cost is the difference); the mean over --calls calls after 200
warm-up calls, one synchronize at the end.
(2) ms an image of infer_occ_order (host clock, median of --reps after
one warm-up) for chip_smoke.py's phase-4 predictors v2 d2, v2 d1, int8c
d2 and bf16 d2 (identity,down,stem) on its scenes of 3, 7, 10 and 16
instances, built as phase 4 builds them (full ResNet-50 width, seed 0).

Prints one JSON line with both, and the card's name and power limit.
Needs a GPU. The tree at --root is built (nvcc) on its first import.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--root', default=os.path.dirname(
        os.path.abspath(__file__)))
    ap.add_argument('--calls', type=int, default=2000)
    ap.add_argument('--reps', type=int, default=21)
    a = ap.parse_args()
    sys.path.insert(0, os.path.abspath(a.root))
    import torch
    if not torch.cuda.is_available():
        print('launch_overhead: no CUDA device', file=sys.stderr)
        return 2
    import chip_smoke as CS
    from instaorder_tpu_torch import serving
    from instaorder_tpu_torch.device import resolve_device
    from instaorder_tpu_torch.eval import pipeline as TPL
    from instaorder_tpu_torch.models import resnet
    from instaorder_tpu_torch.ops import _build
    from instaorder_tpu_torch.ops import pairs as P
    from instaorder_tpu_torch.ops import prep_kernels as PK
    dev = resolve_device()
    card = CS.card_line()
    _build.library()

    # (1) one launch's host time
    img = torch.rand((1, 32, 32, 3), device=dev) * 255
    rois = torch.tensor([[[4.0, 4.0, 20.0, 20.0]]], device=dev)
    wrapped = lambda: PK.fused_prep_rgb(img, rois, out_size=16)  # noqa
    out = wrapped()
    lib = _build.library()

    def raw():
        lib.io_prep_rgb(img.data_ptr(), rois.data_ptr(), out.data_ptr(),
                        1, 1, 32, 32, 16, 3, 1, PK.BAND_ROWS, 0,
                        torch.cuda.current_stream(dev).cuda_stream)
    us = {}
    for name, fn in (('wrapper', wrapped), ('raw', raw),
                     ('wrapper again', wrapped), ('raw again', raw)):
        for _ in range(200):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(a.calls):
            fn()
        torch.cuda.synchronize()
        us[name] = (time.perf_counter() - t0) / a.calls * 1e6

    # (2) phase 4's predictors, per-image ms
    images, masks, bboxes = serving.synthetic_scenes(
        CS.SCENES, CS.HEIGHT, CS.WIDTH, CS.INSTANCES, seed=0)
    sc = serving.upload_scenes(images, masks, bboxes, device=dev)
    pidx = torch.as_tensor(P.all_pair_indices(CS.INSTANCES)[0],
                           dtype=torch.int32, device=dev)
    x = PK.fused_prep_pairs(sc[0], sc[1], pidx,
                            P.pair_rois(sc[2], pidx).contiguous(),
                            out_size=CS.OUT, passes=1)
    nets = CS.predictor_nets(torch, resnet, dev)
    scenes = CS.pred_scenes(serving)
    b16 = torch.bfloat16
    kw = dict(patch_or_image='patch', input_size=CS.OUT,
              prep_impl='pallas5', device=dev)
    preds = {
        'v2 d2': lambda: TPL.make_v2_predictor(
            *nets['InstaOrderNet_od'], 'InstaOrderNet_od', [x],
            prep_dtype=b16, prep_passes=1, **kw),
        'v2 d1': lambda: TPL.make_v2_predictor(
            *nets['InstaOrderNet_od'], 'InstaOrderNet_od', [x],
            prep_dtype=b16, prep_passes=1, directions=1, **kw),
        'int8c d2': lambda: TPL.make_int8_predictor(
            *nets['InstaOrderNet_o'], 'InstaOrderNet_o', [x],
            prep_dtype=b16, **kw),
        'bf16 d2 identity,down,stem': lambda: TPL.make_folded_predictor(
            *nets['InstaOrderNet_o'], 'InstaOrderNet_o', dtype=b16,
            use_pallas=CS.KFEATS, prep_dtype=b16, **kw),
    }
    ms = {}
    for name, make in preds.items():
        pred = make()
        row = []
        for scene in scenes:
            t = []
            for _ in range(a.reps + 1):
                t0 = time.perf_counter()
                pred.infer_occ_order(*scene)
                t.append((time.perf_counter() - t0) * 1e3)
            row.append(sorted(t[1:])[a.reps // 2])
        ms[name] = dict(zip(map(str, CS.PRED_INSTANCES), row),
                        images_per_s=len(row) / (sum(row) / 1e3))
        del pred
        torch.cuda.empty_cache()
    print(card)
    print(json.dumps({'root': a.root, 'launch_us': us,
                      'infer_occ_order_ms': ms, 'card': card}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
