"""Train CLI (counterpart of instaorder_tpu/cli/train.py) — the
reference's main.py flags, plus --device.

    python -m instaorder_tpu_torch.cli.train --config \
        experiments/InstaOrder/InstaOrderNet_o/config.yaml \
        [--load-model PATH [--load-iter N]] [--resume] [--auto-resume] \
        [--validate] [--seed N] [--out-dir DIR] [--device cpu]

--device: 'cuda' (the default) trains on the card and raises without
one; 'cpu' trains on the CPU. One process trains on one device:
--n-devices above 1 and --multihost (data-parallel training) raise
NotImplementedError until the `parallel/` slice is ported (ROADMAP.md).
--load_pretrain raises too (ROADMAP.md queue 1 item 5: compat).
--extract, --evaluate and --evaluate-save are accepted and inert, as in
the reference (main.py:55-58). Reading the YAML needs PyYAML. Every
experiment config trains but the InstaDepthNet ones (ROADMAP.md queue 1
item 4) and midas_pretrained (no training algorithm in either package);
experiments/*/pcnet_m trains the UNet on PartialCompDataset.
"""

from __future__ import annotations

import argparse
import os

_PARALLEL = ('data-parallel training is not ported to instaorder_tpu_torch '
             'yet (ROADMAP.md: the parallel/ slice, 4 GPUs); train on one '
             'device')


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--config', required=True)
    ap.add_argument('--load-model', default=None)
    ap.add_argument('--load-iter', default=None, type=int)
    ap.add_argument('--resume', action='store_true')
    ap.add_argument('--auto-resume', action='store_true',
                    help='if the run dir already has checkpoints, resume '
                         'from the latest one')
    ap.add_argument('--validate', action='store_true')
    ap.add_argument('--load_pretrain', '--load-pretrain', default=None)
    # parsed but inert in the reference too (main.py:55-58)
    ap.add_argument('--extract', action='store_true')
    ap.add_argument('--evaluate', action='store_true')
    ap.add_argument('--evaluate-save', action='store_true')
    ap.add_argument('--seed', type=int, default=131)
    ap.add_argument('--n-devices', type=int, default=None)
    ap.add_argument('--out-dir', default=None)
    ap.add_argument('--multihost', action='store_true')
    ap.add_argument('--device', default='cuda', choices=['cuda', 'cpu'])
    args = ap.parse_args(argv)

    if args.multihost or (args.n_devices or 1) > 1:
        raise NotImplementedError(f'--multihost / --n-devices: {_PARALLEL}')

    from .config import load_config
    from ..train.trainer import Trainer

    cfg = load_config(args.config)
    cfg.seed = args.seed
    if args.load_pretrain:
        cfg.load_pretrain = args.load_pretrain
    trainer = Trainer(cfg, device=args.device, out_dir=args.out_dir)
    if args.load_model:
        path = args.load_model
        if args.load_iter is not None:
            path = os.path.join(path, f'ckpt_iter_{args.load_iter}.ckpt')
        trainer.load(path, resume=args.resume)
    elif args.auto_resume:
        from ..core.checkpoint import latest_checkpoint
        latest = latest_checkpoint(
            os.path.join(trainer.folder, 'checkpoints'))
        if latest is not None:
            trainer.load(latest, resume=True)
    trainer.run(validate_only=args.validate)
    return trainer


if __name__ == '__main__':
    main()
