"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s>
                             --trace <0|1>

from the root of a checkout. The cell, its configuration, traffic mix,
limits and metrics are found by name (portbench/harness.py). The last
line of standard output is one JSON object: correct, attempted, failed,
metrics (the cell's end-to-end metrics, or with --trace 1 its per-layer
metrics), device, with --trace 1 breakdown, and last the compared
numbers beside their limits (also the last lines of standard error).
Exits 2 without a result where the cell's cards are missing, or where
JAX or the JAX package is loaded once the window has closed, in this
process or in any of a cell's rank processes; exits non-zero where the
program cannot be imported.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

T_START = harness.process_start()


def environment():
    """Caches inside the checkout at fixed paths; libraries kept from
    loading JAX; NCCL off /dev/shm."""
    cache = ROOT / '.portbench_cache'
    os.environ['TORCH_EXTENSIONS_DIR'] = str(cache / 'torch_extensions')
    os.environ['TRITON_CACHE_DIR'] = str(cache / 'triton')
    os.environ['USE_FLAX'] = '0'
    os.environ['USE_JAX'] = '0'
    os.environ['NCCL_SHM_DISABLE'] = '1'


def run_cell(workload, seed, seconds, trace, device, plant=None,
             override=None):
    """Run the cell on `device` (a torch.device) and return (result
    object, driver output). override: {'config': {...}, 'mix': {...}}
    entries laid over the cell's files (the CPU tests' small sizes)."""
    bench = harness.benchmark()
    wl, config, mix, limits = harness.cell(bench, workload)
    override = override or {}
    config = dict(config, **override.get('config', {}))
    mix = dict(mix, **override.get('mix', {}))
    ctx = {'workload': workload, 'seed': int(seed), 'seconds': float(seconds),
           'trace': bool(trace), 'device': device, 'chips': wl['chips'],
           'config': config, 'mix': mix, 'limits': limits, 'plant': plant}
    out = harness.driver(mix['driver']).run(ctx)
    setup_s = out['t_window'] - T_START
    return harness.result_line(bench, workload, trace, out, setup_s), out


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    environment()
    bench = harness.benchmark()
    chips = {w['name']: w['chips'] for w in bench['workloads']}[args.workload]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f'portbench: {args.workload} needs {chips} CUDA device(s); '
              f'found {torch.cuda.device_count()}', file=sys.stderr)
        return 2
    res, out = run_cell(args.workload, args.seed, args.seconds, args.trace,
                        torch.device('cuda', 0))
    return report(res, out)


def report(res, out):
    """Print the result line, or, where JAX or the JAX package is loaded
    in this process or was in any rank process once its window closed
    (out['forbidden']), name what was found and return 2 with no result."""
    import json
    loaded = sorted(set(harness.forbidden_modules())
                    | set(out.get('forbidden', ())))
    if loaded:
        print(f'portbench: forbidden modules loaded: {loaded}',
              file=sys.stderr)
        return 2
    print(json.dumps({'info': out.get('info')}), file=sys.stderr)
    for name, c in res['checks'].items():
        print(f'check {name}: {c["value"]!r} limit {c["limit"]!r}',
              file=sys.stderr)
    print(json.dumps(res))
    return 0


if __name__ == '__main__':
    sys.exit(main())
