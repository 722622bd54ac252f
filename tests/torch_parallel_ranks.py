"""Data-parallel ranks for the tests of instaorder_tpu_torch/parallel on
the CPU: `run_ranks(fn, world, tmp, *args)` starts `world` spawned gloo
processes (one torch thread each, a file:// store in `tmp`, so that
parallel test runs never contend for a port), calls fn(rank, world,
*args) in each and returns the ranks' results in rank order. The rank
functions live here, beside it: this module imports no JAX, so a rank
starts with torch and the port alone."""

import contextlib
import os

import numpy as np
import torch

RANK_TIMEOUT = 240          # seconds a spawned world may take


def _rank_main(rank, world, store, fn, args):
    import torch.distributed as dist
    from instaorder_tpu_torch.parallel import init_data_parallel
    torch.set_num_threads(1)
    init_data_parallel(rank, world, 'cpu',
                       init_method=f'file://{store}/rendezvous')
    try:
        out = fn(rank, world, *args)
    finally:
        dist.destroy_process_group()
    torch.save(out, f'{store}/rank{rank}.pt')


def run_ranks(fn, world, tmp, *args):
    """fn(rank, world, *args) in `world` gloo ranks; their results."""
    import torch.multiprocessing as mp
    store = os.path.join(str(tmp), f'ranks_{fn.__name__}')
    os.makedirs(store, exist_ok=True)
    ctx = mp.start_processes(_rank_main, args=(world, store, fn, args),
                             nprocs=world, join=False, daemon=False,
                             start_method='spawn')
    import time
    deadline = time.time() + RANK_TIMEOUT
    while not ctx.join(timeout=max(1.0, deadline - time.time())):
        if time.time() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f'{fn.__name__}: ranks still running after '
                               f'{RANK_TIMEOUT} s')
    return [torch.load(f'{store}/rank{r}.pt', weights_only=False)
            for r in range(world)]


@contextlib.contextmanager
def recorded_relu(masks):
    """torch.relu records `x > 0` of every input into `masks` (numpy)."""
    real = torch.relu

    def relu(x):
        masks.append((x > 0).detach().numpy())
        return real(x)
    torch.relu = relu
    try:
        yield masks
    finally:
        torch.relu = real


# ---- the ranks --------------------------------------------------------------

def collectives_rank(rank, world, x):
    """The gathers of JAX's test_collectives_gather on this rank's shard
    of x, and all_reduce_mean / broadcast_tree on a mixed tree."""
    from instaorder_tpu_torch.parallel import (
        all_reduce_mean, broadcast_tree, gather_tensors, gather_tensors_batch,
        make_mesh, process_allgather, shard_batch)
    mesh = make_mesh(devices=['cpu'] * world)
    mine = shard_batch({'x': x}, mesh, rank)['x']
    ragged = np.arange((rank + 1) * 3, dtype=np.float32).reshape(rank + 1, 3)
    tree = {'a': torch.full((2, 3), float(rank)),
            'b': [torch.tensor(rank, dtype=torch.float64),
                  torch.arange(4, dtype=torch.float32) * (rank + 1)],
            'c': (torch.ones(1, dtype=torch.bfloat16) * rank,)}
    return {
        'shards': gather_tensors(torch.from_numpy(mine)),
        'batch': gather_tensors_batch(mine),
        'allgather': process_allgather(mine),
        'ragged': gather_tensors(ragged),
        'mean': all_reduce_mean(tree),
        'bcast': broadcast_tree({'w': torch.full((3,), float(rank) + 1),
                                 't': torch.tensor(rank, dtype=torch.int32)}),
    }


def step_rank(rank, world, params, stats, cfg, batch, lr, hyper):
    """One SGD step (momentum, weight decay) of InstaOrderNet_o through
    build_train_step with a world-`world` mesh on this rank's shard, its
    ReLU masks recorded; then the eval step's logs."""
    from instaorder_tpu_torch import convert
    from instaorder_tpu_torch.models.registry import get_backbone
    from instaorder_tpu_torch.parallel import make_mesh, shard_batch
    from instaorder_tpu_torch.train import algos, optim, step
    mesh = make_mesh(devices=['cpu'] * world)
    net = get_backbone('resnet50_cls')
    loss_fn = algos.make_loss('InstaOrderNet_o', net, cfg, hyper)
    opt = optim.SGD(0.9, 1e-4)
    shard = {k: torch.from_numpy(v)
             for k, v in shard_batch(batch, mesh, rank).items()}
    p, s = convert.to_torch(params), convert.to_torch(stats)
    with recorded_relu([]) as masks:
        tp, ts, to, logs = step.build_train_step(loss_fn, opt, mesh)(
            p, s, opt.init(p), shard, lr)
    elogs = step.build_eval_step(loss_fn, mesh)(p, s, shard)
    x = torch.from_numpy(np.concatenate(
        [batch['modal1'][..., None], batch['modal2'][..., None],
         batch['rgb']], -1))
    fwd = {train: step.build_forward(net, cfg, mesh, train=train)(p, s, x)
           for train in (False, True)}
    return {'params': convert.to_numpy(tp), 'stats': convert.to_numpy(ts),
            'opt': convert.to_numpy(to),
            'logs': {k: float(v) for k, v in logs.items()},
            'eval_logs': {k: float(v) for k, v in elogs.items()},
            'forward': {k: v.numpy() for k, v in fwd.items()},
            'masks': masks}


def trainer_rank(rank, world, args, out, ckpt, val_args):
    """The port's Trainer as rank `rank` of a cpu mesh: (1) from its own
    init, 2 steps and the checkpoint at 2 (rank 0's); (2) a new Trainer
    resuming `ckpt` (the JAX Trainer's) for 2 steps, each step's ReLU
    masks and loss recorded; the batches each rank trained on; (3)
    validation at val_args' batch_size_val (the error, if any)."""
    import copy
    from instaorder_tpu_torch.convert import to_numpy
    from instaorder_tpu_torch.parallel import make_mesh
    from instaorder_tpu_torch.train.trainer import Trainer
    mesh = make_mesh(devices=['cpu'] * world)
    res = {'fresh_batches': [], 'batches': [], 'masks': [], 'losses': []}

    def recording(t, batches, with_masks):
        real = t.train_step

        def step(params, stats, opt_state, batch, lr):
            batches.append({k: v.numpy().copy() for k, v in batch.items()})
            with recorded_relu([]) as m:
                out_ = real(params, stats, opt_state, batch, lr)
            if with_masks:
                res['masks'].append(m)
                res['losses'].append(float(out_[3]['loss']))
            return out_
        t.train_step = step

    a = copy.deepcopy(args)
    a.model['total_iter'] = 2
    t = Trainer(a, out_dir=f'{out}/fresh', mesh=mesh)
    res['device'] = str(t.device)
    recording(t, res['fresh_batches'], False)
    t.train()
    res['fresh_ckpts'] = sorted(os.listdir(f'{out}/fresh/checkpoints')) \
        if rank == 0 else None
    res['fresh_params'] = to_numpy(t.params)

    t2 = Trainer(copy.deepcopy(args), out_dir=f'{out}/resumed', mesh=mesh)
    t2.load(ckpt, resume=True)
    res['start_iter'] = t2.start_iter
    t2.validate = lambda: None      # at total_iter; not under test here
    recording(t2, res['batches'], True)
    t2.train()
    res['params'] = to_numpy(t2.params)
    res['curr_step'] = t2.curr_step

    t3 = Trainer(copy.deepcopy(val_args), out_dir=f'{out}/val', mesh=mesh)
    try:
        t3.validate()
        res['val_error'] = None
    except ValueError as e:
        res['val_error'] = str(e)
    return res
