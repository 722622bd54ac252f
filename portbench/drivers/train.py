"""Data-parallel training: one process per card, the all-reduced step.

Each rank joins the group (`parallel.mesh.init_data_parallel`, NCCL on
the cards, a `file://` store under TMPDIR), takes the seeded weights
(rank 0's, broadcast as the Trainer does) and builds the step as the
Trainer builds it: `train.algos.make_loss` of the configuration's
algorithm over the registry's net, `train.optim.make_optimizer`, and
`train.step.build_train_step(mesh=)`. Its batches are a pool made on
its card from the seed and its rank.

Set-up drives that one step object through its first three steps, on
batches 0-2 (every row differs), keeping the losses, the first
gradient as the optimizer holds it and the parameters' change after
three steps; two more steps are timed to size the window, whose steps
are the same in number on every rank. The window: those steps back to
back, ended by a synchronize on every rank, its length the longest
rank's. The traced run profiles a few more steps on every rank. Each
rank reports the JAX modules loaded in it once its window has closed
(none where the run is sound), and the result is refused where any is.

Check (rank 0, once the window has closed and the program's state is
freed): the reference follows the same three steps from the same
weights over every rank's batches and is compared number by number.
"""

from __future__ import annotations

import queue
import shutil
import tempfile
import time
import traceback

import numpy as np
import torch

from .. import harness, traffic, weights, yardstick
from ..reference import model as R
from ..reference import train as RT
from .offline import port_cfg

CHECK_STEPS = 3


def run(ctx):
    """One run of the cell, one spawned process a rank (set-up, the
    window, with ctx['trace'] the traced stretch; rank 0 the check).
    Returns what `harness.result_line` reads (t_window, attempted,
    failed, end_to_end, records, checks, info, device), or with
    ctx['reading_seeds'] rank 0's readings instead."""
    world = ctx['chips']
    rdv = tempfile.mkdtemp(prefix='portbench_rdv_')
    shared = {k: ctx.get(k) for k in (
        'seed', 'seconds', 'trace', 'config', 'mix', 'limits', 'plant',
        'reading_seeds', 'control_seeds')}
    shared.update(device=ctx['device'].type, world=world, rdv=rdv)
    mp = torch.multiprocessing.get_context('spawn')
    q = mp.Queue()
    procs = [mp.Process(target=rank_main, args=(r, shared, q))
             for r in range(world)]
    for p in procs:
        p.start()
    outs, err = {}, None
    deadline = time.time() + ctx['mix']['rank_timeout_s']
    try:
        while len(outs) < world and err is None:
            try:
                r, o = q.get(timeout=5.0)
            except queue.Empty:
                dead = [i for i, p in enumerate(procs)
                        if i not in outs and p.exitcode is not None]
                if dead:
                    err = f'ranks {dead} ended without a result'
                elif time.time() > deadline:
                    err = 'ranks timed out'
                continue
            if 'error' in o:
                err = f'rank {r}: {o["error"]}'
            outs[r] = o
    finally:
        for p in procs:
            p.join(timeout=30 if err is None else 5)
            if p.is_alive():
                p.terminate()
                p.join()
        shutil.rmtree(rdv, ignore_errors=True)
    if err is not None:
        raise RuntimeError(err)
    if ctx.get('reading_seeds'):
        return outs[0]
    return merge(ctx, [outs[r] for r in range(world)])


def readings(ctx, seeds, controls):
    """readings.py's lines: the program's first steps on each seed, and on
    those in `controls` the control and the planted faults (`_readings`),
    in one process group."""
    ctx = dict(ctx, reading_seeds=list(seeds), control_seeds=sorted(controls))
    return run(ctx)['readings']


def merge(ctx, outs):
    """The ranks' outputs as one run's: the longest rank's window."""
    cfg, mix = ctx['config'], ctx['mix']
    secs = max(o['window_s'] for o in outs)
    pairs = len(outs) * cfg['batch_size_per_rank'] * outs[0]['steps']
    rec = {'chips': len(outs), 'window_s': secs, 'config': cfg,
           'useful_flops': pairs * 2 * 3 * yardstick.forward_flops(cfg)}
    if ctx['trace'] and all(o.get('trace') for o in outs):
        tr = [o['trace'] for o in outs]
        rec['trace'] = dict(tr[0], busy_s=float(np.mean([t['busy_s']
                                                         for t in tr])),
                            window_s=float(np.mean([t['window_s']
                                                    for t in tr])),
                            nccl_least_s=least_nccl(tr),
                            steps=mix['trace_steps'])
    dev = harness.device_info(ctx['device'], len(outs),
                              max(o['peak'] for o in outs))
    return {'t_window': outs[0]['t_window'], 'attempted': pairs,
            'failed': 0, 'end_to_end': {'train_pairs_per_s': pairs / secs},
            'records': rec, 'checks': outs[0]['checks'],
            'info': outs[0]['info'], 'device': dev,
            'forbidden': sorted({m for o in outs for m in o['forbidden']})}


def least_nccl(traces):
    """Seconds of the traced NCCL kernels counted so that no rank's wait
    for another is in them: for each collective, the shortest of the
    ranks' kernel times (the last rank to arrive waits for none), summed.
    Where the ranks traced different numbers of NCCL kernels, the least
    of the ranks' sums. None where no rank traced one."""
    ks = [t['nccl_kernels'] for t in traces]
    if not any(ks):
        return None
    if any(len(k) != len(ks[0]) for k in ks):
        return float(min(sum(k) for k in ks))
    return float(sum(min(col) for col in zip(*ks)))


def rank_main(rank, ctx, q):
    try:
        q.put((rank, _rank(rank, ctx)))
    except Exception:
        q.put((rank, {'error': traceback.format_exc()[-4000:]}))


def _hyper(config):
    return {'overlap_weight': config['overlap_weight'],
            'distinct_weight': config['distinct_weight'], 'use_rgb': True}


def _join(rank, ctx):
    """This rank's device and mesh, its process group joined."""
    from instaorder_tpu_torch.parallel import init_data_parallel
    world = ctx['world']
    if ctx['device'] == 'cuda':
        dev = torch.device('cuda', rank)
        mesh = [torch.device('cuda', r) for r in range(world)]
    else:
        torch.set_num_threads(1)
        dev = torch.device('cpu')
        mesh = [dev] * world
    init_data_parallel(rank, world, dev,
                       init_method=f'file://{ctx["rdv"]}/store')
    return dev, mesh


def first_steps(ctx, rank, dev, mesh):
    """The program's step object from the seeded weights, driven through
    its first CHECK_STEPS steps: (readings, state, step, batches)."""
    from instaorder_tpu_torch.core.nn import tree_leaves
    from instaorder_tpu_torch.models.registry import get_backbone
    from instaorder_tpu_torch.parallel import broadcast_tree
    from instaorder_tpu_torch.train import algos, optim
    from instaorder_tpu_torch.train.step import build_train_step
    config, seed = ctx['config'], ctx['seed']
    lr, wd = config['lr'], config['weight_decay']
    params, stats = weights.make_trunk(seed, dev, config['in_channels'],
                                       config['bn3_gain'])
    weights.default_heads(params, seed, config['num_classes'], dev)
    params, stats = broadcast_tree(params), broadcast_tree(stats)
    loss_fn = algos.make_loss(config['algo'], get_backbone(config['backbone']),
                              port_cfg(config), _hyper(config))
    opt = optim.make_optimizer(config['optim'], weight_decay=wd)
    step = build_train_step(loss_fn, opt, mesh=mesh)
    opt_state = opt.init(params)
    batches = traffic.train_batches(seed, rank, ctx['mix'], dev,
                                    ctx['mix']['pool'],
                                    config['batch_size_per_rank'])
    p0 = [t.detach().clone() for t in tree_leaves(params)]
    losses = []
    for s in range(CHECK_STEPS):
        params, stats, opt_state, logs = step(params, stats, opt_state,
                                              batches[s], lr)
        losses.append(logs['loss'])
        if s == 0:
            g1 = torch.stack([(b - wd * p).norm() for b, p in zip(
                tree_leaves(opt_state['buf']), p0)])
    dp = torch.stack([(p - a).norm() for p, a in zip(tree_leaves(params), p0)])
    prog = {'loss': torch.stack(losses).cpu(), 'grad': g1.cpu(),
            'update': dp.cpu()}
    return prog, [params, stats, opt_state], step, batches


def _rank(rank, ctx):
    import torch.distributed as dist
    dev, mesh = _join(rank, ctx)
    harness.plant(ctx, rank)
    if ctx.get('reading_seeds'):
        return _readings(rank, ctx, dev, mesh)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == 'cuda' \
        else (lambda: None)
    mix, lr = ctx['mix'], ctx['config']['lr']
    prog, state, step, batches = first_steps(ctx, rank, dev, mesh)
    k = CHECK_STEPS

    def steps(n):
        nonlocal k
        for _ in range(n):
            state[:3] = step(*state, batches[k % len(batches)], lr)[:3]
            k += 1
    sync()
    t = time.perf_counter()
    steps(mix['size_steps'])
    sync()
    per = (time.perf_counter() - t) / mix['size_steps']
    n = torch.tensor([max(1, round(ctx['seconds'] / per))], device=dev)
    dist.all_reduce(n, op=dist.ReduceOp.MAX)
    n = int(n.item())
    dist.barrier()
    sync()
    t_window = time.time()
    t = time.perf_counter()
    steps(n)
    sync()
    out = {'t_window': t_window, 'window_s': time.perf_counter() - t,
           'steps': n}
    if ctx['trace']:
        with harness.profiler(dev) as prof:
            # the ranks' profilers start apart: line them up first, so
            # that the traced all-reduces do not wait for a profiler
            dist.barrier()
            sync()
            with torch.profiler.record_function(harness.WINDOW):
                steps(mix['trace_steps'])
                sync()
        out['trace'] = harness.reduce_trace(prof)
    out['peak'] = torch.cuda.max_memory_allocated(dev) \
        if dev.type == 'cuda' else 0
    del state, batches, step
    if dev.type == 'cuda':
        torch.cuda.empty_cache()
    dist.barrier()
    if rank == 0:
        out['checks'], out['info'] = compare(ctx, prog, reference(ctx, dev))
    dist.barrier()
    dist.destroy_process_group()
    out['forbidden'] = harness.forbidden_modules()
    return out


def _readings(rank, ctx, dev, mesh):
    """The compared numbers of the program's first steps on each of
    ctx['reading_seeds'], and on ctx['control_seeds'] those of the
    control (the reference in TF32) and of the planted faults (half of
    each rank's batch; the exchange left out), each against the
    reference; no window."""
    import torch.distributed as dist
    out = {'readings': []}
    for seed in ctx['reading_seeds']:
        c = dict(ctx, seed=seed)
        prog, state, step, batches = first_steps(c, rank, dev, mesh)
        del state, step, batches
        if dev.type == 'cuda':
            torch.cuda.empty_cache()
        dist.barrier()
        if rank == 0:
            ref = reference(c, dev)
            r = {'seed': seed, 'program': gaps(prog, ref)}
            if seed in ctx['control_seeds']:
                r['control'] = gaps(reference(c, dev, tf32=True), ref)
                for f in ('half', 'no_exchange'):
                    r[f'fault_{f}'] = gaps(reference(c, dev, fault=f), ref)
            out['readings'].append(r)
            print(r, flush=True)
        dist.barrier()
    dist.destroy_process_group()
    return out


def reference(ctx, dev, tf32=False, fault=None):
    """The reference's three steps over every rank's batches from the
    seeded weights: {'loss' (3,), 'grad' (leaves,), 'update' (leaves,)}
    norms, the leaves in the tree's order."""
    config, mix, seed = ctx['config'], ctx['mix'], ctx['seed']
    lr, wd = config['lr'], config['weight_decay']
    params, _stats = weights.make_trunk(seed, dev, config['in_channels'],
                                       config['bn3_gain'])
    weights.default_heads(params, seed, config['num_classes'], dev)
    ranks = [traffic.train_batches(seed, r, mix, dev, CHECK_STEPS,
                                  config['batch_size_per_rank'])
             for r in range(ctx['world'])]
    p0 = RT.leaves(params)
    p, buf, losses = list(p0), [None] * len(p0), []
    with R.tf32(tf32):
        for s in range(CHECK_STEPS):
            loss, g = RT.grads_mean(RT.rebuild(params, iter(p)),
                                    [rb[s] for rb in ranks], config, fault)
            if s == 0:
                g1 = torch.stack([x.norm() for x in g])
            p, buf = RT.sgd(p, g, buf, lr, wd)
            losses.append(loss)
    dp = torch.stack([(a - b).detach().norm() for a, b in zip(p, p0)])
    return {'loss': torch.stack(losses).cpu(), 'grad': g1.cpu(),
            'update': dp.cpu()}


def gaps(prog, ref):
    """The compared numbers: the worst step's loss gap relative to the
    reference's loss; for the first gradient and the change after three
    steps the worst leaf's gap between the two norms, relative to the
    larger of that leaf's reference norm and the median leaf's; and the
    median leaf's gap of the change, steady from seed to seed where the
    worst leaf's carries the ReLU and max-pool flips of steps 2-3.
    Leaves whose reference gradient is under a thousandth of the median
    leaf's (nought to rounding) are left out of both."""
    loss = ((prog['loss'] - ref['loss']).abs() / ref['loss'].abs()).max()
    med_g = ref['grad'].median()
    keep = ref['grad'] >= 1e-3 * med_g

    def rel(a, b):
        a, b = a[keep], b[keep]
        return (a - b).abs() / torch.clamp(b, min=b.median())
    g, u = rel(prog['grad'], ref['grad']), rel(prog['update'], ref['update'])
    idx = torch.nonzero(keep)[:, 0]
    return {'loss_gap': float(loss), 'grad_gap': float(g.max()),
            'update_gap': float(u.max()),
            'update_gap_median': float(u.median()),
            'worst_update_leaf': int(idx[u.argmax()]),
            'leaves_kept': int(keep.sum()), 'leaves': int(keep.numel())}


def compare(ctx, prog, ref):
    g = gaps(prog, ref)
    lim = ctx['limits']
    checks = [harness.check(k, g[k], lim[k]) for k in (
        'loss_gap', 'grad_gap', 'update_gap', 'update_gap_median')]
    return checks, {k: g[k] for k in ('leaves_kept', 'leaves',
                                      'worst_update_leaf')}
