"""Checkpoint interop between the port's Trainer and the JAX package's
on the CPU.

JAX's Trainer (n_devices=1) trains 2 steps and saves; the port's Trainer
and JAX's each resume from that file and train 2 more. Bars: start_iter
equal, the logged losses within 1e-4 relative, the final params within
1e-4 of each leaf's max |update| (plus one f32 spacing of the value).
JAX's steps follow the port's ReLU branch (test_torch_train_step.py's
docstring says why). Then a port-written checkpoint loads into JAX's
Trainer with no warning, its params and optimizer state equal.
"""

import os

import jax
import numpy as np
import pytest

from instaorder_tpu.train import step as JST
from instaorder_tpu.train.trainer import Trainer as JTrainer

from instaorder_tpu_torch.convert import to_numpy
from instaorder_tpu_torch.data import synthetic
from instaorder_tpu_torch.train.trainer import Trainer

from test_torch_train_step import (  # noqa: F401 (a fixture)
    one_torch_thread, recorded_relu, relu_on)
from test_torch_trainer import make_args
import torch_threads  # noqa: F401 (the suite's torch thread cap)


@pytest.fixture(scope='module')
def fixture(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('interop'))
    insta, _, img = synthetic.make_instaorder_fixture(root)
    return {'root': root, 'insta': insta, 'img': img}


def leaves(tree):
    return jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray,
                                                            tree))


def test_checkpoint_interop_with_jax(fixture, tmp_path):
    ja = JTrainer(make_args(fixture, total_iter=2), n_devices=1,
                  out_dir=str(tmp_path / 'jax'))
    ja.validate = lambda: None      # at total_iter; not under test here
    ja.train()
    ck2 = os.path.join(str(tmp_path / 'jax'), 'checkpoints',
                       'ckpt_iter_2.ckpt')
    start = leaves(ja.params)

    # the port resumes JAX's checkpoint; each step's ReLU masks recorded
    pt = Trainer(make_args(fixture), device='cpu',
                 out_dir=str(tmp_path / 'port'))
    pt.load(ck2, resume=True)
    masks, port_losses = [], []
    real = pt.train_step

    def recording(*a):
        with recorded_relu([]) as m:
            out = real(*a)
        masks.append(m)
        port_losses.append(float(out[3]['loss']))
        return out

    pt.train_step = recording
    pt.train()

    # JAX's Trainer resumes the same file; each step on the port's branch
    jb = JTrainer(make_args(fixture), n_devices=1,
                  out_dir=str(tmp_path / 'jax2'))
    jb.load(ck2, resume=True)
    assert jb.start_iter == pt.start_iter == 2
    branches = iter(masks)
    jax_losses = []

    def on_branch(*a):
        with relu_on(next(branches)):
            out = JST.build_train_step(jb.loss_fn, jb.optimizer,
                                       jb.mesh)(*a)
        jax_losses.append(float(out[3]['loss']))
        return out

    jb.train_step = on_branch
    jb.validate = lambda: None
    jb.train()
    assert pt.curr_step == jb.curr_step == 4
    np.testing.assert_allclose(port_losses, jax_losses, rtol=1e-4)
    got, want = leaves(to_numpy(pt.params)), leaves(jb.params)
    for i, (a, b, c) in enumerate(zip(got, want, start)):
        upd = float(np.abs(b - c).max())
        excess = np.abs(a - b) - np.spacing(np.abs(b).astype(np.float32))
        assert float(excess.max()) <= 1e-4 * upd, (i, excess.max(), upd)

    # a port-written checkpoint resumes in JAX's Trainer with no warning
    ck4 = os.path.join(str(tmp_path / 'port'), 'checkpoints',
                       'ckpt_iter_4.ckpt')
    jc = JTrainer(make_args(fixture, total_iter=6), n_devices=1,
                  out_dir=str(tmp_path / 'jax3'))
    warned = []
    jc.logger.info = warned.append
    jc.load(ck4, resume=True)
    assert jc.start_iter == 4
    assert not [w for w in warned if 'caution' in w], warned
    for a, b in zip(leaves(jc.params), leaves(to_numpy(pt.params))):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(leaves(jc.opt_state), leaves(to_numpy(pt.opt_state))):
        np.testing.assert_array_equal(a, b)
