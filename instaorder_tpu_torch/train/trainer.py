"""Trainer — the training orchestration (counterpart of
instaorder_tpu/train/trainer.py).

Parity with reference trainer.py (Trainer.__init__/run/train/validate):
seeding, file + console logger, registry model construction, resume from
`iter_` in the checkpoint filename, per-iteration LR schedule, periodic
validation with the val_iter cap, checkpoints, telemetry
(utils/telemetry.make_summary_logger). Without a mesh it trains on one
device: `device=None` is the card (device.resolve_device raises without
one), 'cpu' the CPU.

With a mesh (parallel/mesh.make_mesh; this process one rank of its
process group, parallel/mesh.init_data_parallel) it is one replica of
data-parallel training, as the reference's ranks: it runs on
mesh[rank], loads only its own stream (DistributedGivenIterationSampler
of its rank at the YAML's per-rank batch_size: the ranks' batches
together are the JAX package's global batch, rank r's the rows its mesh
device r holds, after a resume too), and the train and eval steps
all-reduce (train/step.py). Rank 0 broadcasts the params and statistics
after init and after a load (the reference's broadcast_params); rank 0
alone writes the log file, the telemetry and the checkpoints, and every
rank loads them. Validation follows the JAX package: the global val
batch is batch_size_val, split over the ranks, and must divide by the
world size.

The weights are drawn from a torch.Generator seeded with `args.seed`, so
a seed gives the same net on every device (not the JAX package's net:
its PRNG differs; a JAX-written checkpoint carries a net across).
A step's logs stay on the device until print_freq, where they are read
and a non-finite loss raises FloatingPointError.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Dict

import numpy as np
import torch

from ..cli.config import load_config
from ..core import checkpoint as ckpt
from ..core.nn import param_count
from ..core.schedule import step_lr
from ..data.datasets import DATASETS
from ..data.loader import DataLoader
from ..data.sampler import (DistributedGivenIterationSampler,
                            DistributedSequentialSampler)
from ..device import resolve_device
from ..models.registry import get_backbone
from ..parallel.collectives import broadcast_tree
from ..parallel.mesh import data_rank
from ..utils.telemetry import SummaryLogger, make_summary_logger
from .algos import make_loss
from .optim import make_optimizer
from .step import build_eval_step, build_train_step


class AverageMeter:
    """Windowed average (reference utils/common_utils.py:81-109)."""

    def __init__(self, length=0):
        self.length = length
        self.reset()

    def reset(self):
        self.history = []
        self.count = 0
        self.sum = 0.0
        self.val = 0.0
        self.avg = 0.0

    def update(self, val):
        if self.length > 0:
            self.history.append(val)
            if len(self.history) > self.length:
                del self.history[0]
            self.val = self.history[-1]
            self.avg = float(np.mean(self.history))
        else:
            self.val = val
            self.sum += val
            self.count += 1
            self.avg = self.sum / self.count


def create_logger(name, log_file, level=logging.INFO):
    logger = logging.getLogger(name)
    for h in list(logger.handlers):
        h.close()
    logger.handlers.clear()
    fmt = logging.Formatter('[%(asctime)s] %(message)s')
    fh = logging.FileHandler(log_file)
    fh.setFormatter(fmt)
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.setLevel(level)
    logger.addHandler(fh)
    logger.addHandler(sh)
    return logger


def batch_to_device(batch, device):
    """A collated numpy batch as tensors on `device`: floating fields in
    f32, the label fields in their integer (or bool) type."""
    out = {}
    for k, a in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(a))
        if t.is_floating_point():
            t = t.float()
        out[k] = t.to(device)
    return out


def _on_device(tree, device):
    """A tree as loaded by core/checkpoint.load_state (numpy leaves where
    the file had them, the trainer's tensors elsewhere) as tensors on
    `device`: floating leaves in f32, integer ones (Adam's t) as they
    are."""
    if isinstance(tree, dict):
        return {k: _on_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_on_device(v, device) for v in tree]
    t = tree if isinstance(tree, torch.Tensor) else \
        torch.from_numpy(np.array(tree))
    return (t.float() if t.is_floating_point() else t).to(device)


def silent_logger(name):
    """A logger that writes nothing (the ranks other than 0)."""
    logger = logging.getLogger(name)
    logger.handlers.clear()
    logger.addHandler(logging.NullHandler())
    logger.propagate = False
    return logger


class Trainer:
    def __init__(self, args, device=None, out_dir=None, mesh=None):
        if isinstance(args, str):
            args = load_config(args)
        self.args = args
        self.mesh = mesh
        if mesh is None:
            self.rank, self.world_size = 0, 1
            self.device = resolve_device(device)
        else:
            self.rank, self.world_size = data_rank(mesh), len(mesh)
            self.device = resolve_device(mesh[self.rank])
        model_cfg: Dict[str, Any] = args.model
        data_cfg: Dict[str, Any] = args.data
        trainer_cfg: Dict[str, Any] = args.trainer

        exp = trainer_cfg.get('exp_name', 'exp')
        base = out_dir or os.path.join(
            data_cfg.get('base_dir', '.'), 'data', 'out', 'InstaOrder', exp)
        self.folder = base
        if self.rank == 0:
            os.makedirs(os.path.join(base, 'logs'), exist_ok=True)
            os.makedirs(os.path.join(base, 'checkpoints'), exist_ok=True)
            self.logger = create_logger(
                f'instaorder_tpu_torch.{exp}',
                os.path.join(base, 'logs', 'log_train.txt'))
            # wandb/tensorboardX telemetry (reference trainer.py:39-66)
            self.summary = make_summary_logger(
                trainer_cfg, base, run_name=f'Train/{exp}',
                config=vars(args) if hasattr(args, '__dict__') else None)
        else:
            self.logger = silent_logger(
                f'instaorder_tpu_torch.{exp}.rank{self.rank}')
            self.summary = SummaryLogger()

        algo = model_cfg['algo']
        self.algo = algo
        seed = getattr(args, 'seed', 131)
        gen = torch.Generator().manual_seed(seed)
        self.net = get_backbone(model_cfg.get('backbone_arch', algo))
        bparams = dict(model_cfg.get('backbone_param', {}))
        self.params, self.stats, self.net_cfg = self.net['init'](
            gen, device=self.device, **bparams)
        self._ingest_pretrained(model_cfg)
        self._broadcast()
        self.loss_fn = make_loss(algo, self.net, self.net_cfg, model_cfg)
        self.optimizer = make_optimizer(
            model_cfg['optim'],
            weight_decay=model_cfg.get('weight_decay', 0.0),
            beta1=model_cfg.get('beta1', 0.9))
        self.opt_state = self.optimizer.init(self.params)
        self.lr_fn = step_lr(model_cfg['lr'], model_cfg['lr_steps'],
                             model_cfg['lr_mults'],
                             model_cfg.get('warmup_lr', []),
                             model_cfg.get('warmup_steps', []))
        self.train_step = build_train_step(self.loss_fn, self.optimizer,
                                           mesh)
        self.eval_step = build_eval_step(self.loss_fn, mesh)

        self.start_iter = 0
        self.curr_step = 0
        self.logger.info(f'#parameters: {param_count(self.params)}')

    def _ingest_pretrained(self, model_cfg):
        """Training-time pretrained ingest (reference main.py:38-39 +
        single_stage_model.py:17-27), through compat/torch_convert:

          * `pretrained_weight` (the MiDaS model-f6b98070.pt) for the
            InstaDepthNet / midas algos: the disparity path only, the
            order branches keep their init (midas_net.py:30-45). A
            missing file warns, and training starts from scratch (the
            JAX package's documented deviation: the reference crashes).
          * `load_pretrain: <path>` (the config or --load_pretrain): a
            torch state_dict merged strict=False onto the init, family
            'midas' for InstaDepthNet, 'unet' for PartialCompletionMask,
            else 'resnet' (resnet_cls.py:227-232). The reference's
            `pretrained: True` URL download is not supported (no
            network); pass a local path.
        """
        from ..compat.torch_convert import load_pretrain
        algo = self.algo
        pw = model_cfg.get('pretrained_weight')
        if pw and (algo.startswith('InstaDepthNet') or 'midas' in algo):
            if os.path.isfile(pw):
                self.params, self.stats = load_pretrain(
                    pw, self.params, self.stats, self.net_cfg,
                    family='midas_base', warn=self.logger.info,
                    device=self.device)
                self.logger.info(f'=> loaded pretrained_weight {pw}')
            else:
                self.logger.info(
                    f'caution: pretrained_weight {pw} not found; training '
                    f'the disp trunk from scratch (the reference would '
                    f'require this asset)')
        lp = model_cfg.get('load_pretrain') or getattr(
            self.args, 'load_pretrain', None)
        if isinstance(lp, str) and lp:
            family = ('midas' if algo.startswith('InstaDepthNet')
                      else 'unet' if algo == 'PartialCompletionMask'
                      else 'resnet')
            self.params, self.stats = load_pretrain(
                lp, self.params, self.stats, self.net_cfg, family=family,
                warn=self.logger.info, device=self.device)
            self.logger.info(f'=> loaded pretrain {lp}')

    def _broadcast(self):
        """Rank 0's params and statistics on every rank (no-op without a
        mesh)."""
        if self.mesh is not None:
            self.params = broadcast_tree(self.params)
            self.stats = broadcast_tree(self.stats)

    # -- checkpointing -----------------------------------------------------
    def save(self, step):
        """Rank 0 writes the checkpoint and returns its path; the other
        ranks write nothing and return None."""
        if self.rank != 0:
            return None
        path = ckpt.save_state(os.path.join(self.folder, 'checkpoints'),
                               step, self.params, self.stats,
                               self.opt_state)
        self.logger.info(f'saved {path}')
        return path

    def load(self, path, resume=True):
        step, params, stats, opt = ckpt.load_state(
            path, self.params, self.stats,
            self.opt_state if resume else None, warn=self.logger.info)
        self.params = _on_device(params, self.device)
        self.stats = _on_device(stats, self.device)
        self._broadcast()
        if resume and opt is not None:
            self.opt_state = _on_device(opt, self.device)
            self.start_iter = step
            self.curr_step = step
        self.logger.info(f"=> loaded checkpoint '{path}' (iter {step})")

    # -- data --------------------------------------------------------------
    def _make_loader(self, phase):
        """This rank's loader: the train stream of its rank at the
        per-rank batch_size; the sequential val stream's global batches
        of batch_size_val, this rank's 1/world rows of each."""
        data_cfg = self.args.data
        ds_cls = DATASETS[data_cfg['trainval_dataset']]
        dataset = ds_cls(data_cfg, phase, self.algo)
        world, rank = self.world_size, self.rank
        if phase == 'train':
            batch = data_cfg['batch_size']
            sampler = DistributedGivenIterationSampler(
                len(dataset), self.args.model['total_iter'], batch, world,
                rank, last_iter=self.start_iter - 1)
        else:
            total = data_cfg.get('batch_size_val', data_cfg['batch_size'])
            if total % world:
                raise ValueError(
                    f'batch_size_val={total} must be divisible by the mesh '
                    f'size ({world}) so the eval step can shard it')
            batch = total // world
            stream = list(DistributedSequentialSampler(len(dataset), 1, 0))
            sampler = [stream[(i * world + rank) * batch + j]
                       for i in range(len(stream) // total)
                       for j in range(batch)]
        return DataLoader(dataset, sampler, batch,
                          num_workers=data_cfg.get('workers', 4),
                          mode=data_cfg.get('loader_mode', 'thread'),
                          rank=rank, world_size=world)

    # -- loops -------------------------------------------------------------
    def run(self, validate_only=False):
        if validate_only:
            self.validate()
            return
        if self.args.trainer.get('initial_val', False):
            self.validate()
        self.train()

    def train(self):
        tcfg = self.args.trainer
        total_iter = self.args.model['total_iter']
        print_freq = tcfg.get('print_freq', 100)
        save_freq = tcfg.get('save_freq', 2000)
        val_freq = tcfg.get('val_freq', 2000)

        loader = self._make_loader('train')
        # the step and data times (host clock, the last 10 iterations)
        self.btime = btime = AverageMeter(10)
        self.dtime = dtime = AverageMeter(10)
        recorder: Dict[str, AverageMeter] = {}
        # the steps' device-side logs, read at print_freq, so that logging
        # never stalls the device (the reference syncs every iteration,
        # trainer.py:175); every iteration's loss reaches the recorder
        pending = []

        end = time.time()
        for i, batch in enumerate(loader):
            self.curr_step = self.start_iter + i
            lr = self.lr_fn(self.curr_step)
            dtime.update(time.time() - end)

            batch = batch_to_device(batch, self.device)
            self.params, self.stats, self.opt_state, logs = self.train_step(
                self.params, self.stats, self.opt_state, batch, lr)

            pending.append(logs)
            btime.update(time.time() - end)
            end = time.time()
            self.curr_step += 1

            if self.curr_step % print_freq == 0:
                for logd in pending:
                    for k, v in logd.items():
                        v = float(v)
                        # a NaN/Inf loss poisons every later step: fail
                        # with the step number, so that a relaunch
                        # (--auto-resume) restarts from the last good
                        # checkpoint; the check rides the print_freq read
                        if k in tcfg.get('loss_record', ['loss']) and \
                                not np.isfinite(v):
                            raise FloatingPointError(
                                f'non-finite {k}={v} at iter '
                                f'{self.curr_step} — diverged; resume '
                                f'from the last checkpoint with a lower '
                                f'lr')
                        recorder.setdefault(k, AverageMeter(10)).update(v)
                pending.clear()
                # reference trainer.py:185-193: lr + per-loss averages
                self.summary.scalar('lr', lr, self.curr_step)
                self.summary.scalar('batch_time', btime.avg, self.curr_step)
                self.summary.scalar('data_time', dtime.avg, self.curr_step)
                for k, m in recorder.items():
                    self.summary.scalar(f'train_{k}', m.avg, self.curr_step)
                loss_str = '\t'.join(
                    f'{k}: {m.val:.4g} ({m.avg:.4g})'
                    for k, m in recorder.items())
                self.logger.info(
                    f'Iter: [{self.curr_step}/{total_iter}]\t'
                    f'Time {btime.val:.3f} ({btime.avg:.3f})\t'
                    f'Data {dtime.val:.3f} ({dtime.avg:.3f})\t'
                    f'{loss_str}\tlr {lr:.2g}')
            if (self.curr_step % save_freq == 0 or
                    self.curr_step == total_iter):
                self.save(self.curr_step)
            if (self.curr_step % val_freq == 0 or
                    self.curr_step == total_iter):
                self.validate()
            if self.curr_step >= total_iter:
                break

    def validate(self):
        tcfg = self.args.trainer
        val_iter = tcfg.get('val_iter', -1)
        loader = self._make_loader('val')
        recorder: Dict[str, AverageMeter] = {}
        for i, batch in enumerate(loader):
            if val_iter != -1 and i == val_iter:
                break
            logs = self.eval_step(self.params, self.stats,
                                  batch_to_device(batch, self.device))
            for k, v in logs.items():
                recorder.setdefault(k, AverageMeter(10)).update(float(v))
        # reference trainer.py:249-252: val_<k> at the current train step
        for k, m in recorder.items():
            self.summary.scalar(f'val_{k}', m.avg, self.curr_step)
        loss_str = '\t'.join(f'{k}: {m.val:.4g} ({m.avg:.4g})'
                             for k, m in recorder.items())
        self.logger.info(f'Validation Iter: [{self.curr_step}]\t{loss_str}')
        return {k: m.avg for k, m in recorder.items()}
