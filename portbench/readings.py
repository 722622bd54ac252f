"""The readings the limits of `correct` are set from, on the chip at a
cell's own size: the compared numbers of sound runs of the program on
many seeds, and those of the control (the next precision below the
configuration's) and of planted faults on a few, all in one process.

    python3 portbench/readings.py --workload <name> --seeds 1,2,...
        [--control-seeds 1,2,3] [--plant MODULE:FUNCTION] [--seconds 3]
        [--out FILE]

Prints one JSON line a seed; --out also writes them all to FILE. The
cell's driver (its traffic file's `driver`) reads them, through its
`readings(ctx, seeds, controls)`; see its docstring for what the
program, the control and its faults are there. --plant plants a fault
(`portbench/tests/faults.py`) under the program first, so that the
"program" numbers are the fault's.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness, run  # noqa: E402


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', required=True)
    ap.add_argument('--control-seeds', default='')
    ap.add_argument('--plant', default=None)
    ap.add_argument('--seconds', type=float, default=3.0)
    ap.add_argument('--out', default=None)
    args = ap.parse_args(argv)
    run.environment()
    import torch
    bench = harness.benchmark()
    wl, config, mix, limits = harness.cell(bench, args.workload)
    ctx = {'workload': args.workload, 'seed': None, 'seconds': args.seconds,
           'trace': False, 'device': torch.device('cuda', 0),
           'chips': wl['chips'], 'config': config, 'mix': mix,
           'limits': limits, 'plant': args.plant}
    seeds = [int(s) for s in args.seeds.split(',')]
    controls = {int(s) for s in args.control_seeds.split(',') if s}
    lines = harness.driver(mix['driver']).readings(ctx, seeds, controls)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(''.join(json.dumps(r) + '\n'
                                          for r in lines))
    return 0


if __name__ == '__main__':
    sys.exit(main())
