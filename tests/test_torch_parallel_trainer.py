"""The port's Trainer and train CLI across data-parallel ranks on the CPU
(gloo ranks with one torch thread each, tests/torch_parallel_ranks.py),
against the JAX package's Trainer on its conftest's virtual CPU mesh.

  * world 2 against JAX's Trainer(n_devices=2): each rank's batch at
    every step, fresh and after a resume, is the rows of JAX's global
    batch that its mesh device holds (items and augmentations); JAX's
    checkpoint at 2, resumed by the port's ranks and by JAX's Trainer
    for 2 steps each, at test_torch_trainer_interop.py's bars (losses
    1e-4 relative, params 1e-4 of each leaf's max |update| plus an f32
    spacing), JAX's replicas on the port's ranks' ReLU branches; rank 0
    alone writes the checkpoint; a batch_size_val that does not divide
    by the world size raises in both;
  * --multihost under `python -m torch.distributed.run` (two ranks).
The CLI's --n-devices is held in test_torch_trainer.py::test_cli.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from instaorder_tpu.train.trainer import Trainer as JTrainer

from instaorder_tpu_torch.data import synthetic

import torch_parallel_ranks as R
from test_torch_parallel import _jax_step_on_branches, stacked
from test_torch_trainer import REPO, config_file, make_args  # noqa: F401
from test_torch_train_step import leaves
import torch_threads  # noqa: F401 (the suite's torch thread cap)

WORLD = 2


@pytest.fixture(scope='module')
def fixture(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('ptrainer'))
    insta, _, img = synthetic.make_instaorder_fixture(root)
    return {'root': root, 'insta': insta, 'img': img}


def recording(t, batches, step=None):
    """t.train_step (or `step`) with each global batch recorded."""
    real = step or t.train_step

    def rec(*a):
        batches.append(jax.tree_util.tree_map(np.asarray, a[3]))
        return real(*a)
    t.train_step = rec


def hold_rows(port_batches, jax_batches, rank):
    """A rank's batches are its rows of JAX's global batches."""
    assert len(port_batches) == len(jax_batches)
    for got, want in zip(port_batches, jax_batches):
        assert sorted(got) == sorted(want)
        for k in want:
            n = want[k].shape[0] // WORLD
            np.testing.assert_array_equal(
                got[k], want[k][rank * n:(rank + 1) * n], err_msg=k)


def test_world2_trainer_against_jax(fixture, tmp_path):
    ja = JTrainer(make_args(fixture, total_iter=2), n_devices=WORLD,
                  out_dir=str(tmp_path / 'jax'))
    ja.validate = lambda: None      # at total_iter; not under test here
    fresh = []
    recording(ja, fresh)
    ja.train()
    ck2 = os.path.join(str(tmp_path / 'jax'), 'checkpoints',
                       'ckpt_iter_2.ckpt')
    start = leaves(ja.params)

    val_args = make_args(fixture)
    val_args.data['batch_size_val'] = 3
    with pytest.raises(ValueError, match='divisible'):
        JTrainer(val_args, n_devices=WORLD,
                 out_dir=str(tmp_path / 'jval')).validate()
    res = R.run_ranks(R.trainer_rank, WORLD, tmp_path, make_args(fixture),
                      str(tmp_path / 'port'), ck2, val_args)
    for r, out in enumerate(res):
        assert out['device'] == 'cpu'
        hold_rows(out['fresh_batches'], fresh, r)
        assert out['start_iter'] == 2 and out['curr_step'] == 4
        assert 'divisible' in out['val_error']
        for a, b in zip(leaves(out['fresh_params']),
                        leaves(res[0]['fresh_params'])):
            np.testing.assert_array_equal(a, b)
    # rank 0 alone wrote the log and the checkpoint
    assert res[0]['fresh_ckpts'] == ['ckpt_iter_2.ckpt']
    assert sorted(os.listdir(tmp_path / 'port' / 'fresh')) == [
        'checkpoints', 'logs']
    assert os.listdir(tmp_path / 'port' / 'fresh' / 'logs') == [
        'log_train.txt']

    # JAX's Trainer resumes the same file; its replicas on the ranks'
    # branches, step by step
    jb = JTrainer(make_args(fixture), n_devices=WORLD,
                  out_dir=str(tmp_path / 'jax2'))
    jb.load(ck2, resume=True)
    assert jb.start_iter == 2
    branches = iter(zip(*[out['masks'] for out in res]))
    step = _jax_step_on_branches(jb.loss_fn, jb.optimizer, jb.mesh)
    jax_losses, resumed = [], []

    def on_branch(*a):
        out = step(*a, stacked(next(branches)))
        jax_losses.append(float(out[3]['loss']))
        return out
    recording(jb, resumed, on_branch)
    jb.validate = lambda: None
    jb.train()
    assert jb.curr_step == 4
    for r, out in enumerate(res):
        hold_rows(out['batches'], resumed, r)
        np.testing.assert_allclose(out['losses'], jax_losses, rtol=1e-4)
        got, want = leaves(out['params']), leaves(jb.params)
        for i, (a, b, c) in enumerate(zip(got, want, start)):
            upd = float(np.abs(b - c).max())
            excess = np.abs(a - b) - np.spacing(np.abs(b).astype(np.float32))
            assert float(excess.max()) <= 1e-4 * upd, (r, i, excess.max())


def test_multihost_under_torchrun(config_file, tmp_path):  # noqa: F811
    """--multihost joins a torchrun launch: two CPU ranks train the
    config's one step; rank 0 writes the checkpoint and the log."""
    out = str(tmp_path / 'mh')
    env = dict(os.environ, OMP_NUM_THREADS='1',
               PYTHONPATH=os.pathsep.join(
                   [str(REPO), os.environ.get('PYTHONPATH', '')]))
    run = subprocess.run(
        [sys.executable, '-m', 'torch.distributed.run', '--standalone',
         '--nproc-per-node', str(WORLD), '-m',
         'instaorder_tpu_torch.cli.train', '--config', config_file,
         '--multihost', '--device', 'cpu', '--out-dir', out],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=R.RANK_TIMEOUT)
    assert run.returncode == 0, run.stderr[-3000:]
    assert os.listdir(os.path.join(out, 'checkpoints')) == [
        'ckpt_iter_1.ckpt']
    log = open(os.path.join(out, 'logs', 'log_train.txt')).read()
    assert log.count('Iter: [1/1]') == 1, log
    # outside torchrun it raises
    from instaorder_tpu_torch.cli import train as cli_train
    with pytest.raises(RuntimeError, match='torchrun'):
        cli_train.main(['--config', config_file, '--multihost', '--device',
                        'cpu', '--out-dir', out])
