"""Train CLI (counterpart of instaorder_tpu/cli/train.py) — the
reference's main.py flags, plus --device.

    python -m instaorder_tpu_torch.cli.train --config \
        experiments/InstaOrder/InstaOrderNet_o/config.yaml \
        [--load-model PATH [--load-iter N]] [--resume] [--auto-resume] \
        [--validate] [--seed N] [--out-dir DIR] [--device cpu] \
        [--n-devices N | --multihost]

--device: 'cuda' (the default) trains on the cards and raises without
one; 'cpu' trains on the CPU. Data-parallel training (parallel/, the
reference's NCCL ranks): --n-devices N starts N ranks, one process each
(torch.multiprocessing.spawn, non-daemonic, so that the loader's
process workers still start inside a rank), NCCL on cuda:0..N-1, or
gloo on the CPU with --device cpu; fewer than N cards raises. Without
--n-devices the card path trains on every visible card, as the JAX
package's make_mesh(None), and --device cpu in one process. A world of
1 is the one-device Trainer in this process. --multihost joins a
torchrun launch instead (python -m torch.distributed.run ... -m
instaorder_tpu_torch.cli.train --multihost): this process is the rank
torchrun names. The YAML's batch_size is per rank. --load_pretrain
merges a torch state_dict onto the init
(compat/torch_convert.load_pretrain). --extract, --evaluate and
--evaluate-save are accepted and inert, as in the reference (main.py:
55-58). Reading the YAML needs PyYAML. Every experiment config of
experiments/{InstaOrder,COCOA,KINS} trains: experiments/*/pcnet_m trains
the UNet on PartialCompDataset, experiments/InstaOrder/InstaDepthNet_*
the MiDaS networks (their `pretrained_weight` loaded when the file
exists). midas_pretrained has no training algorithm in either package,
and experiments/{DIW,kitti}/InstaDepthNet_d are evaluation configs (no
total_iter, no trainval_dataset): their training fails with a KeyError,
as the JAX package's does.
"""

from __future__ import annotations

import argparse
import os
import tempfile


def main(argv=None):
    """Train as the command line asks. Returns the Trainer of this
    process, or None when --n-devices spawned the ranks."""
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

    from ..parallel import make_mesh
    if args.multihost:
        if args.n_devices is not None:
            raise ValueError('--multihost takes its ranks from torchrun; '
                             'drop --n-devices')
        import torch.distributed as dist
        from ..parallel import init_from_env
        mesh, _ = init_from_env(args.device)
        try:
            return train(args, mesh)
        finally:
            dist.destroy_process_group()
    if args.device == 'cpu':
        mesh = make_mesh(devices=['cpu'] * (args.n_devices or 1))
    else:
        mesh = make_mesh(args.n_devices)     # raises with fewer cards
    if len(mesh) == 1:
        return train(args, None, mesh[0])
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as store:
        mp.spawn(_rank, args=(args, mesh, f'file://{store}/rendezvous'),
                 nprocs=len(mesh), join=True, daemon=False)
    return None


def _rank(rank, args, mesh, init_method):
    """One spawned rank of --n-devices: join the group, train, leave."""
    import torch
    import torch.distributed as dist
    from ..parallel import init_data_parallel
    if mesh[rank].type == 'cpu':
        # the ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // len(mesh)))
    init_data_parallel(rank, len(mesh), mesh[rank], init_method=init_method)
    try:
        train(args, mesh)
    finally:
        dist.destroy_process_group()


def train(args, mesh, device=None):
    """Build the Trainer of the parsed command line (on `device`, or as
    this process's rank of `mesh`), load or resume as asked, and run
    it. Returns the Trainer."""
    from .config import load_config
    from ..train.trainer import Trainer

    cfg = load_config(args.config)
    cfg.seed = args.seed
    if args.load_pretrain:
        cfg.load_pretrain = args.load_pretrain
    trainer = Trainer(cfg, device=device, out_dir=args.out_dir, mesh=mesh)
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
