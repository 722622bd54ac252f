"""PCNet-M training in the port against the JAX package's on the CPU:
`PartialCompDataset`, the Trainer and the train CLI on the three
experiments/*/pcnet_m configs.

  * PartialCompDataset samples equal to JAX's on every value (the RGB
    within 1 LSB on under 1% of its values before normalisation, as in
    tests/test_torch_train_data.py: cv2's cubic resize is fixed-point)
    for several seeds, in train and val, with load_rgb on and off, once
    with max_eraser_shrink > 0, on the InstaOrder, COCOA and KINS
    fixtures;
  * the Trainer: JAX's trains 2 steps from a seeded unet1d2 and saves;
    the port's and JAX's each resume that file and train 2 more, JAX's
    on the port's ReLU branch and pool argmaxes (test_torch_unet.py says
    why). Bars: the logged losses within 1e-4 relative, the final
    params within 1e-4 of each leaf's max |update| plus one f32 spacing
    of the value (tests/test_torch_trainer_interop.py's bars; a conv
    bias that feeds a train-mode BatchNorm, whose gradient is 0, on the
    tree's largest update);
  * `cli.train --device cpu` on each pcnet_m config (its net cut to
    unet1d2 and 36^2 patches, batch 2), on fixtures: a step, a
    checkpoint, finite logs.
"""

import os

import jax
import numpy as np
import pytest
import yaml

from instaorder_tpu.data import datasets as JD
from instaorder_tpu.models import unet as JU
from instaorder_tpu.train import step as JST
from instaorder_tpu.train import trainer as JTM

from instaorder_tpu_torch.cli import train as cli_train
from instaorder_tpu_torch.cli.config import load_config
from instaorder_tpu_torch.convert import to_numpy
from instaorder_tpu_torch.data import datasets as TD
from instaorder_tpu_torch.data import synthetic
from instaorder_tpu_torch.train.trainer import Trainer

from test_torch_train_data import assert_samples_match
from test_torch_train_step import (  # noqa: F401 (a fixture)
    one_torch_thread, recorded_relu, relu_on)
from test_torch_unet import REPO, pool_on, recorded_pool, seeded_net
import torch_threads  # noqa: F401 (the suite's torch thread cap)

SAMPLES = 6


@pytest.fixture(scope='module')
def fixtures(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('pcnet_train'))
    insta, _, img = synthetic.make_instaorder_fixture(
        root, n_images=3, n_instances=4, h=90, w=140, seed=3)
    return {'root': root, 'InstaOrder': (insta, img),
            'COCOA': synthetic.make_cocoa_fixture(root),
            'KINS': synthetic.make_kins_fixture(root)}


def pcnet_raw(dataset, fixtures, **data):
    """experiments/<dataset>/pcnet_m/config.yaml (as PyYAML reads it) with
    its train and val paths on the fixture and `data` keys replaced."""
    raw = yaml.safe_load(open(REPO / 'experiments' / dataset / 'pcnet_m' /
                              'config.yaml'))
    ann, img = fixtures[dataset]
    raw['data'].update(train_annot_file=ann, val_annot_file=ann,
                       train_image_root=img, val_image_root=img, **data)
    return raw


# (case, dataset, phase, data keys)
DATASET_CASES = [
    ('instaorder_train', 'InstaOrder', 'train', {}),
    ('instaorder_train_rgb', 'InstaOrder', 'train', {'load_rgb': True}),
    ('instaorder_val', 'InstaOrder', 'val', {}),
    ('instaorder_val_rgb', 'InstaOrder', 'val', {'load_rgb': True}),
    ('instaorder_shrink', 'InstaOrder', 'train',
     {'max_eraser_shrink': 3, 'load_rgb': True}),
    ('cocoa_train', 'COCOA', 'train', {'use_category': True}),
    ('kins_train', 'KINS', 'train', {}),
]


@pytest.mark.parametrize('case,dataset,phase,data', DATASET_CASES,
                         ids=[c[0] for c in DATASET_CASES])
def test_partial_comp_dataset_matches_jax(fixtures, case, dataset, phase,
                                          data):
    cfg = dict(pcnet_raw(dataset, fixtures, input_size=64, **data)['data'])
    jds = JD.PartialCompDataset(cfg, phase)
    tds = TD.DATASETS['PartialCompDataset'](cfg, phase,
                                            'PartialCompletionMask')
    assert len(tds) == len(jds) > 0
    for i in range(SAMPLES):
        idx = (3 * i) % len(jds)
        want = jds.sample(idx, np.random.RandomState(200 + i))
        got = tds.sample(idx, np.random.RandomState(200 + i))
        assert_samples_match(got, want, f'{case} {idx}')
        assert got['target'].dtype == np.int32
        if data.get('load_rgb'):
            assert np.abs(got['rgb']).max() > 0


def trainer_args(fixtures, total_iter):
    """The InstaOrder pcnet_m config as load_config gives it, its net cut
    to unet1d2 at 36^2 patches, batch 3, one loader worker."""
    raw = pcnet_raw('InstaOrder', fixtures, input_size=36, batch_size=3,
                    batch_size_val=3, workers=1, base_dir=fixtures['root'])
    raw['model'].update(backbone_arch='unet1d2', total_iter=total_iter)
    raw['trainer'].update(tensorboard=False, initial_val=False,
                          print_freq=1, save_freq=2, val_freq=1000,
                          val_iter=1)
    path = os.path.join(fixtures['root'], f'pcnet_{total_iter}.yaml')
    with open(path, 'w') as f:
        yaml.safe_dump(raw, f)
    args = load_config(path)
    args.seed = 0
    return args


def leaves(tree):
    return jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray,
                                                            tree))


def test_trainer_matches_jax(fixtures, tmp_path, monkeypatch):
    params, stats, cfg = seeded_net('unet1d2', 21)
    # JAX's Trainer draws no net: it starts from the seeded tree
    monkeypatch.setattr(JTM, 'get_backbone', lambda name: {
        'init': lambda key, **kw: (params, stats, cfg), 'apply': JU.apply})
    ja = JTM.Trainer(trainer_args(fixtures, 2), n_devices=1,
                     out_dir=str(tmp_path / 'jax'))
    ja.validate = lambda: None
    ja.train()
    ck2 = str(tmp_path / 'jax' / 'checkpoints' / 'ckpt_iter_2.ckpt')
    start = leaves(ja.params)

    pt = Trainer(trainer_args(fixtures, 4), device='cpu',
                 out_dir=str(tmp_path / 'port'))
    pt.load(ck2, resume=True)
    branches, port_losses = [], []
    real = pt.train_step

    def recording(*a):
        with recorded_relu([]) as m, recorded_pool([]) as idx:
            out = real(*a)
        branches.append((m, idx))
        port_losses.append(float(out[3]['loss']))
        return out
    pt.train_step = recording
    pt.validate = lambda: None
    pt.train()

    jb = JTM.Trainer(trainer_args(fixtures, 4), n_devices=1,
                     out_dir=str(tmp_path / 'jax2'))
    jb.load(ck2, resume=True)
    assert jb.start_iter == pt.start_iter == 2
    it = iter(branches)
    jax_losses = []

    def on_branch(*a):
        masks, idx = next(it)
        with relu_on(masks), pool_on(idx):
            out = JST.build_train_step(jb.loss_fn, jb.optimizer,
                                       jb.mesh)(*a)
        jax_losses.append(float(out[3]['loss']))
        return out
    jb.train_step = on_branch
    jb.validate = lambda: None
    jb.train()
    assert pt.curr_step == jb.curr_step == 4
    np.testing.assert_allclose(port_losses, jax_losses, rtol=1e-4)
    paths = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(jb.params)[0]]
    triples = list(zip(leaves(to_numpy(pt.params)), leaves(jb.params),
                       start))
    tree_upd = max(float(np.abs(b - c).max()) for _, b, c in triples)
    for path, (a, b, c) in zip(paths, triples):
        # a conv bias that feeds a train-mode BatchNorm has gradient 0:
        # its update is rounding, held on the tree's largest update
        zero = path.endswith(("['conv1']['b']", "['conv2']['b']"))
        upd = tree_upd if zero else float(np.abs(b - c).max())
        excess = np.abs(a - b) - np.spacing(np.abs(b).astype(np.float32))
        assert float(excess.max()) <= 1e-4 * upd, (path, excess.max(), upd)


@pytest.mark.parametrize('dataset', ['InstaOrder', 'COCOA', 'KINS'])
def test_cli_train(fixtures, dataset, tmp_path):
    raw = pcnet_raw(dataset, fixtures, input_size=36, batch_size=2,
                    batch_size_val=2, workers=1, base_dir=str(tmp_path))
    raw['model'].update(backbone_arch='unet1d2', total_iter=1)
    raw['trainer'].update(tensorboard=False, print_freq=1, val_iter=1)
    path = tmp_path / 'config.yaml'
    path.write_text(yaml.safe_dump(raw))
    out = str(tmp_path / 'run')
    t = cli_train.main(['--config', str(path), '--out-dir', out,
                        '--device', 'cpu'])
    assert t.curr_step == 1 and t.algo == 'PartialCompletionMask'
    assert os.path.isfile(os.path.join(out, 'checkpoints',
                                       'ckpt_iter_1.ckpt'))
    assert np.isfinite(t.validate()['loss'])
