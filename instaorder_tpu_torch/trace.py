#!/usr/bin/env python
"""Where the serving megastep's time goes on the GPU: device time by
kernel (torch.profiler, CUDA activity) and the device's idle share over
the traced steps, at the bench.py configuration.

    python -m instaorder_tpu_torch.trace [--profile serving-d1]
        [--dtype int8c|int8|bf16|f32] [--prep-rgb ...]
        [--pallas-features ...]
        [--no-pallas] [--directions 1|2] [--prep-precision ...]
        [--prep-stage1 f32|bf16]
        [--pairs-per-step 1620]

Prints a table (device ms per step by kernel name) and ONE JSON line:
  {"step_ms", "device_busy_ms", "idle_share", "pairs_per_step",
   "device", "top": [[name, calls_per_step, ms_per_step], ...]}
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from . import serving
from .bench import add_profile_args, build_step, resolve
from .device import resolve_device
from .ops.pairs import all_pair_indices


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--pairs-per-step', type=int, default=1620)
    add_profile_args(ap)
    args = ap.parse_args(argv)
    steps, top = 3, 16
    dev = resolve_device()
    n = 10
    S = max(1, int(np.ceil(args.pairs_per_step / 45)))
    sc = serving.upload_scenes(*serving.synthetic_scenes(S, 480, 640, n),
                               device=dev)
    pidx = torch.as_tensor(all_pair_indices(n)[0], device=dev)
    step = build_step(args, sc, pidx, 256, dev)
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as tracer:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / steps * 1e3
    rows = []
    for e in tracer.key_averages():
        # kernels only: an operator's row repeats its kernels' time
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = e.self_device_time_total
        if dev_us > 0:
            rows.append((e.key, e.count / steps,
                         dev_us / 1e3 / steps))
    rows.sort(key=lambda r: -r[2])
    busy = sum(r[2] for r in rows)
    print(f'{"kernel":60s} {"calls":>7s} {"ms/step":>9s} {"share":>6s}')
    for name, calls, ms in rows[:top]:
        print(f'{name[:60]:60s} {calls:7.1f} {ms:9.3f} {ms / busy:6.1%}')
    print(json.dumps({
        'step_ms': wall, 'device_busy_ms': busy,
        'idle_share': max(0.0, 1.0 - busy / wall),
        'pairs_per_step': S * 45, 'profile': args.profile,
        'dtype': resolve(args)['dtype'],
        'device': torch.cuda.get_device_name(dev),
        'top': [[name, calls, ms] for name, calls, ms in rows[:top]],
    }))


if __name__ == '__main__':
    main()
