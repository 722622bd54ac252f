"""The port's parallel/ (mesh, collectives) and the data-parallel train,
eval and forward steps against the JAX package's on the CPU.

The port's ranks are gloo processes (tests/torch_parallel_ranks.py: one
torch thread each, a file:// store in tmp_path); JAX's side runs on its
conftest's 8 virtual CPU devices. The net is resnet50_cls with
layers_override (1, 1, 1, 1) at 64x64, made in JAX from a seed and
carried across with convert.py; the batch (8 pairs, 2 a replica) from a
numpy seed (test_torch_train_step.make_batch).

The world-4 step is held at test_torch_train_step.py's bars (loss 1e-5
relative, params 1e-4 of each leaf's max |update| plus an f32 spacing,
statistics 1e-5, optimizer state 1e-4), each replica on its own ReLU
branch: JAX's shard_map step takes each replica's masks, recorded by the
port's rank, as a sharded input and follows them the way that file's
`relu_on` does. Against the port's own one-device steps on the four
shards, averaged (an SGD step is linear in the gradient, so the mean of
the one-device steps is the world-4 step): within 1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from instaorder_tpu.models import resnet as jresnet
from instaorder_tpu.parallel import make_mesh as j_make_mesh
from instaorder_tpu.parallel import shard_batch as j_shard_batch
from instaorder_tpu.parallel.collectives import gather_tensors as j_gather
from instaorder_tpu.train import algos as JA
from instaorder_tpu.train import optim as JO
from instaorder_tpu.train import step as JST

from instaorder_tpu_torch import convert
from instaorder_tpu_torch import parallel as TP
from instaorder_tpu_torch.train import algos as TA
from instaorder_tpu_torch.train import optim as TO
from instaorder_tpu_torch.train import step as TST

import torch_parallel_ranks as R
from test_torch_train_step import (  # noqa: F401 (a fixture)
    NET, jax_net, leaves, make_batch, one_torch_thread, relu_on, to_port,
    worst)
import torch_threads  # noqa: F401 (the suite's torch thread cap)

WORLD = 4
HYPER = {'use_rgb': True}
LR = 0.01


def test_make_mesh():
    mesh = TP.make_mesh(devices=['cpu'] * 8)
    assert mesh == [torch.device('cpu')] * 8
    assert TP.make_mesh(3, devices=['cpu'] * 8) == [torch.device('cpu')] * 3
    # fewer devices than asked raises, as JAX's make_mesh does
    with pytest.raises(ValueError, match='only 2 devices'):
        TP.make_mesh(4, devices=['cpu'] * 2)
    with pytest.raises(ValueError):
        j_make_mesh(9)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no GPU'):
            TP.make_mesh()
    # a mesh of several devices needs its process group
    with pytest.raises(RuntimeError, match='process group'):
        TP.data_rank(mesh)
    assert TP.data_rank(mesh[:1]) == 0
    with pytest.raises(RuntimeError, match='process group'):
        TST.build_train_step(None, None, mesh)


def test_shard_batch_rows_match_jax():
    batch = make_batch(8, 3, 2)
    jmesh = j_make_mesh(WORLD)
    jb = j_shard_batch(batch, jmesh)
    mesh = TP.make_mesh(devices=['cpu'] * WORLD)
    order = list(jmesh.devices.flat)
    for k, arr in jb.items():
        for s in arr.addressable_shards:
            r = order.index(s.device)
            got = TP.shard_batch(batch, mesh, r)[k]
            np.testing.assert_array_equal(got, np.asarray(s.data))
            tgot = TP.shard_batch(to_port(batch), mesh, r)[k]
            assert isinstance(tgot, torch.Tensor)
            np.testing.assert_array_equal(tgot.numpy(), np.asarray(s.data))
    with pytest.raises(ValueError, match='divide'):
        TP.shard_batch(make_batch(6, 3, 2), mesh, 0)
    with pytest.raises(ValueError, match='outside'):
        TP.shard_batch(batch, mesh, WORLD)


X = np.arange(32, dtype=np.float32).reshape(8, 4)


def test_collectives_world1():
    """JAX's test_collectives_gather in one process: one shard, the
    batch, process_allgather the identity; all_reduce_mean and
    broadcast_tree return their tree."""
    shards = TP.gather_tensors(torch.from_numpy(X))
    assert len(shards) == 1
    np.testing.assert_array_equal(shards[0], X)
    np.testing.assert_array_equal(TP.gather_tensors_batch(X), X)
    np.testing.assert_array_equal(TP.process_allgather(X), X)
    np.testing.assert_array_equal(TP.process_allgather(torch.from_numpy(X)),
                                  X)
    tree = {'a': torch.ones(2), 'b': [torch.zeros(3)]}
    assert TP.all_reduce_mean(tree) is tree
    assert TP.broadcast_tree(tree) is tree


def test_collectives_world4(tmp_path):
    """In 4 gloo ranks: the gathers give JAX's shards of make_mesh(4)
    (test_pairs.py::test_collectives_gather's contract), ragged shapes
    come back cropped, all_reduce_mean averages a mixed tree (f32, f64,
    bf16 leaves) in each leaf's dtype, broadcast_tree gives rank 0's
    leaves of every dtype."""
    res = R.run_ranks(R.collectives_rank, WORLD, tmp_path, X)
    jshards = j_gather(j_shard_batch({'x': X}, j_make_mesh(WORLD))['x'])
    assert len(jshards) == WORLD
    for r, out in enumerate(res):
        assert len(out['shards']) == WORLD
        for got, want in zip(out['shards'], jshards):
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(out['batch'], X)
        np.testing.assert_array_equal(out['allgather'], np.stack(jshards))
        for k, a in enumerate(out['ragged']):
            np.testing.assert_array_equal(
                a, np.arange((k + 1) * 3, dtype=np.float32).reshape(k + 1, 3))
        m = out['mean']
        assert torch.equal(m['a'], torch.full((2, 3), 1.5))
        assert m['b'][0].dtype == torch.float64 and float(m['b'][0]) == 1.5
        assert torch.equal(m['b'][1], torch.arange(4.0) * 2.5)
        assert m['c'][0].dtype == torch.bfloat16 and float(m['c'][0]) == 1.5
        assert torch.equal(out['bcast']['w'], torch.ones(3))
        assert out['bcast']['t'].dtype == torch.int32
        assert int(out['bcast']['t']) == 0


def _jax_step_on_branches(loss_fn, opt, mesh):
    """JAX's build_train_step body with each replica's ReLU masks as a
    sharded input (stacked on a leading replica axis): replica r follows
    rank r's branch."""
    def _step(params, stats, opt_state, batch, lr, masks):
        with relu_on([m[0] for m in masks]):
            grads, (new_stats, logs) = jax.grad(
                lambda p: loss_fn(p, stats, batch, train=True),
                has_aux=True)(params)
        grads = jax.lax.pmean(grads, 'data')
        new_stats = jax.lax.pmean(new_stats, 'data')
        logs = jax.lax.pmean(logs, 'data')
        new_params, new_opt = opt.update(grads, opt_state, params, lr)
        return new_params, new_stats, new_opt, logs
    return jax.jit(shard_map(
        _step, mesh=mesh,
        in_specs=(P(), P(), P(), P('data'), P(), P('data')),
        out_specs=(P(), P(), P(), P()), check_vma=False))


def stacked(masks_by_rank):
    """[rank][k] masks -> [k] arrays with a leading rank axis."""
    return [np.stack([m[k] for m in masks_by_rank])
            for k in range(len(masks_by_rank[0]))]


def hold_step(got, want, p0, logs, jlogs):
    """test_torch_train_step.test_train_step_against_jax's bars."""
    np.testing.assert_allclose(logs['loss'], float(jlogs['loss']), rtol=1e-5)
    g, w, c = leaves(got['params']), leaves(want[0]), leaves(p0)
    for i, (a, b, z) in enumerate(zip(g, w, c)):
        upd = float(np.abs(b - z).max())
        excess = np.abs(a - b) - np.spacing(np.abs(b).astype(np.float32))
        assert float(excess.max()) <= 1e-4 * upd, (i, excess.max(), upd)
    err, leaf = worst(got['stats'], want[1], 'stats')
    assert err <= 1e-5, (leaf, err)
    err, leaf = worst(got['opt'], want[2], 'opt_state')
    assert err <= 1e-4, (leaf, err)


@pytest.fixture(scope='module')
def world4(tmp_path_factory):
    """The port's world-4 step, eval step and forwards (every rank's
    results), on the net and batch of the module docstring."""
    params, stats, cfg = jax_net(0, 2)
    batch = make_batch(2 * WORLD, 11, 2)
    res = R.run_ranks(R.step_rank, WORLD, tmp_path_factory.mktemp('w4'),
                      params, stats, cfg, batch, LR, HYPER)
    return params, stats, cfg, batch, res


def test_world4_step_matches_jax(world4):
    params, stats, cfg, batch, res = world4
    # every rank holds the same new trees and logs
    for r in res[1:]:
        for k in ('params', 'stats', 'opt'):
            for a, b in zip(leaves(r[k]), leaves(res[0][k])):
                np.testing.assert_array_equal(a, b)
        assert r['logs'] == res[0]['logs']
    jopt = JO.SGD(0.9, 1e-4)
    mesh = j_make_mesh(WORLD)
    jstep = _jax_step_on_branches(
        JA.make_loss('InstaOrderNet_o', jresnet.apply, cfg, HYPER), jopt,
        mesh)
    out = jstep(jax.tree_util.tree_map(jnp.asarray, params), stats,
                jopt.init(params), j_shard_batch(batch, mesh), LR,
                stacked([r['masks'] for r in res]))
    hold_step(res[0], out, params, res[0]['logs'], out[3])


def test_world4_step_is_the_mean_of_one_device_steps(world4):
    """The mean of the port's one-device steps on the four shards is the
    world-4 step (1e-6 relative); the statistics of one step on the
    whole batch differ (BatchNorm is per replica)."""
    params, stats, cfg, batch, res = world4
    opt = TO.SGD(0.9, 1e-4)
    step = TST.build_train_step(
        TA.make_loss('InstaOrderNet_o', NET, cfg, HYPER), opt)
    p, s = convert.to_torch(params), convert.to_torch(stats)
    mesh = TP.make_mesh(devices=['cpu'] * WORLD)
    outs = []
    for r in range(WORLD):
        shard = to_port(TP.shard_batch(batch, mesh, r))
        tp, ts, to, logs = step(p, s, opt.init(p), shard, LR)
        outs.append((convert.to_numpy(tp), convert.to_numpy(ts),
                     convert.to_numpy(to), float(logs['loss'])))
    mean = lambda k: jax.tree_util.tree_map(  # noqa: E731
        lambda *a: np.mean(np.stack(a).astype(np.float64), 0),
        *[o[k] for o in outs])
    np.testing.assert_allclose(res[0]['logs']['loss'],
                               np.mean([o[3] for o in outs]), rtol=1e-6)
    for k, name in ((0, 'params'), (1, 'stats'), (2, 'opt')):
        err, leaf = worst(res[0][name], mean(k), name)
        assert err <= 1e-6, (name, leaf, err)
    _, ts, _, _ = step(p, s, opt.init(p), to_port(batch), LR)
    err, _ = worst(res[0]['stats'], convert.to_numpy(ts), 'stats')
    assert err > 1e-3, err


def test_world4_eval_step_and_forward_match_jax(world4):
    params, stats, cfg, batch, res = world4
    mesh = j_make_mesh(WORLD)
    loss = JA.make_loss('InstaOrderNet_o', jresnet.apply, cfg, HYPER)
    jlogs = JST.build_eval_step(loss, mesh)(
        jax.tree_util.tree_map(jnp.asarray, params), stats,
        j_shard_batch(batch, mesh))
    for r in res:
        assert sorted(r['eval_logs']) == sorted(jlogs)
        for k, v in jlogs.items():
            np.testing.assert_allclose(r['eval_logs'][k], float(v),
                                       rtol=1e-5)
    # build_forward: the sharded batch's outputs gathered on every rank,
    # against JAX's build_forward over make_mesh(4) (train: per-replica
    # BatchNorm statistics)
    x = np.concatenate([batch['modal1'][..., None],
                        batch['modal2'][..., None], batch['rgb']], -1)
    for train in (False, True):
        want = np.asarray(JST.build_forward(jresnet.apply, cfg, mesh,
                                            train=train)(params, stats, x))
        for r in res:
            got = r['forward'][train]
            assert got.shape == want.shape
            err = np.abs(got - want).max() / np.abs(want).max()
            assert err <= 1e-5, (train, err)
