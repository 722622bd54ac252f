"""InstaDepthNet training through the port's Trainer and train CLI on the
CPU, on the port's InstaOrder fixture.

  * `cli.train --device cpu` on experiments/InstaOrder/InstaDepthNet_{d,od}
    (their nets cut to trunk_layers = branch_layers = (1, 1, 1, 1),
    features 8, 64^2, batch 2): _od ingests its `pretrained_weight` (a
    MidasNet-style state dict of tests/torch_ref.py), every trunk and
    decoder leaf equal to the file's and the branches to their init; _d's
    file is missing, which warns and trains from scratch; one step and a
    finite validation each;
  * experiments/{DIW,kitti}/InstaDepthNet_d are evaluation configs: both
    packages' Trainers fail on them with the same KeyError (the loss's
    `overlap_weight`), after the same missing-pretrained_weight warning;
  * one build_train_step step of _od: its occlusion branch, which the
    YAML's loss does not reach (occ_order_weight 0), moves by SGD's weight
    decay alone, as under JAX's zero gradients.
"""

import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from instaorder_tpu.cli.config import load_config as jload_config
from instaorder_tpu.train import trainer as JTM
from instaorder_tpu.train.trainer import Trainer as JTrainer

from instaorder_tpu_torch import convert
from instaorder_tpu_torch.cli import train as cli_train
from instaorder_tpu_torch.cli.config import load_config
from instaorder_tpu_torch.compat.torch_convert import conv_w
from instaorder_tpu_torch.compat.torch_convert_midas import (
    midas_base_from_torch_state_dict)
from instaorder_tpu_torch.core.nn import tree_leaves
from instaorder_tpu_torch.data import synthetic
from instaorder_tpu_torch.models import midas as tmidas
from instaorder_tpu_torch.models.registry import get_backbone
from instaorder_tpu_torch.train import algos as TA
from instaorder_tpu_torch.train import optim as TO
from instaorder_tpu_torch.train import step as TST
from instaorder_tpu_torch.train.trainer import Trainer

from test_torch_train_step import one_torch_thread  # noqa: F401 (a fixture)
from torch_ref import TorchMidasOracle
import torch_threads  # noqa: F401 (the suite's torch thread cap)

REPO = Path(__file__).resolve().parent.parent
SMALL = [1, 1, 1, 1]
FEATURES = 8
CUT = {'trunk_layers': SMALL, 'branch_layers': SMALL, 'features': FEATURES}


@pytest.fixture(scope='module')
def fixture(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('depth_trainer'))
    insta, _, img = synthetic.make_instaorder_fixture(root, n_images=2)
    return {'root': root, 'insta': insta, 'img': img}


def depth_raw(name, fixture, pretrained):
    """experiments/InstaOrder/<name>/config.yaml as PyYAML reads it, its
    net cut to size, its paths on the fixture."""
    raw = yaml.safe_load(open(REPO / 'experiments' / 'InstaOrder' / name /
                              'config.yaml'))
    raw['model'].update(total_iter=1, pretrained_weight=pretrained)
    raw['model']['backbone_param'].update(CUT)
    raw['data'].update(
        base_dir='', train_annot_file=fixture['insta'],
        val_annot_file=fixture['insta'], train_image_root=fixture['img'],
        val_image_root=fixture['img'], input_size=64, batch_size=2,
        batch_size_val=2, workers=1)
    raw['trainer'].update(tensorboard=False, initial_val=False,
                          print_freq=1, val_iter=1)
    return raw


@pytest.mark.parametrize('name', ['InstaDepthNet_d', 'InstaDepthNet_od'])
def test_cli_train_instadepthnet(fixture, tmp_path, name):
    pretrained = str(tmp_path / 'model-f6b98070.pt')
    oracle = None
    if name == 'InstaDepthNet_od':
        oracle = TorchMidasOracle(trunk_layers=tuple(SMALL),
                                  features=FEATURES, variant='midas')
        torch.save(oracle.state_dict(), pretrained)
    path = tmp_path / 'config.yaml'
    path.write_text(yaml.safe_dump(depth_raw(name, fixture, pretrained)))
    out = str(tmp_path / 'run')
    ingested = {}
    real_train = Trainer.train

    def train(self):
        ingested['params'] = [x.clone() for x in tree_leaves(self.params)]
        ingested['tree'] = self.params
        return real_train(self)
    Trainer.train = train
    try:
        t = cli_train.main(['--config', str(path), '--out-dir', out,
                            '--device', 'cpu', '--seed', '0'])
    finally:
        Trainer.train = real_train
    assert t.curr_step == 1 and t.algo == name
    assert os.path.isfile(os.path.join(out, 'checkpoints',
                                       'ckpt_iter_1.ckpt'))
    assert np.isfinite(t.validate()['loss'])
    log = open(os.path.join(out, 'logs', 'log_train.txt')).read()
    # the tree the Trainer trained from: the file's disparity path, the
    # branches at the init of the same seed
    fresh, _, cfg = get_backbone(name)['init'](
        torch.Generator().manual_seed(0), device='cpu', **CUT)
    p0 = ingested['tree']
    if oracle is None:
        assert 'caution: pretrained_weight' in log and 'not found' in log
        for a, b in zip(ingested['params'], tree_leaves(fresh)):
            assert torch.equal(a, b)
        return
    assert '=> loaded pretrained_weight' in log
    assert 'missing key from checkpoint: params.do' in log
    sd = oracle.state_dict()
    assert torch.equal(p0['out_conv1']['w'],
                       conv_w(sd['scratch.output_conv.0.weight']))
    assert torch.equal(p0['trunk']['layer3'][0]['conv2']['w'],
                       conv_w(sd['pretrained.layer3.0.conv2.weight']))
    base, _ = midas_base_from_torch_state_dict(sd, cfg)
    assert sorted(base) == sorted(k for k in p0 if k not in ('do', 'oo'))
    for k in base:
        got, want = tree_leaves(p0[k]), tree_leaves(base[k])
        assert len(got) == len(want) > 0
        assert all(torch.equal(a, b) for a, b in zip(got, want)), k
    for k in ('do', 'oo'):
        for a, b in zip(tree_leaves(p0[k]), tree_leaves(fresh[k])):
            assert torch.equal(a, b)


@pytest.mark.parametrize('dataset', ['DIW', 'kitti'])
def test_eval_configs_fail_to_train_as_in_jax(dataset, tmp_path,
                                              monkeypatch):
    path = str(REPO / 'experiments' / dataset / 'InstaDepthNet_d' /
               'config.yaml')
    # JAX's Trainer draws its net with the port's init (numpy trees; the
    # same structure and cfg), which saves JAX's ~20 s init of the trunk:
    # the failure comes after the net is built
    real = JTM.get_backbone

    def jget(name):
        entry = dict(real(name))
        entry['init'] = lambda key, **kw: (
            lambda p, s, c: (convert.to_numpy(p), convert.to_numpy(s), c))(
            *get_backbone(name)['init'](torch.Generator().manual_seed(0),
                                        device='cpu', **kw))
        return entry
    monkeypatch.setattr(JTM, 'get_backbone', jget)
    errors, logs = [], []
    for pkg, load, make in (
            ('jax', jload_config,
             lambda a: JTrainer(a, n_devices=1, out_dir=str(tmp_path / 'j'))),
            ('port', load_config,
             lambda a: Trainer(a, device='cpu',
                               out_dir=str(tmp_path / 'p')))):
        a = load(path)
        a.model['backbone_param'].update(CUT)
        a.trainer['tensorboard'] = False
        a.seed = 0
        with pytest.raises(KeyError) as e:
            make(a).run()
        errors.append(e.value.args)
        logs.append(open(tmp_path / pkg[0] / 'logs' /
                         'log_train.txt').read())
    assert errors[0] == errors[1] == ('overlap_weight',)
    assert all('caution: pretrained_weight //data/out/InstaOrder_ckpt/'
               'model-f6b98070.pt not found' in log for log in logs)


def test_unreached_branch_decays(fixture):
    """_od at its YAML's loss weights: the `oo` leaves get zero gradients
    and SGD's weight decay alone moves them. At the YAML's lr (1e-5) and
    weight decay (1e-4) that move, 1e-9 of a weight, rounds away in f32
    in either package; lr 1 shows it."""
    raw = depth_raw('InstaDepthNet_od', fixture, '')
    m = raw['model']
    p, s, cfg = tmidas.init(torch.Generator().manual_seed(3),
                            variant='instadepthnet_od', **CUT)
    rng = np.random.RandomState(0)
    n, size = 2, 64
    m1 = np.zeros((n, size, size), np.float32)
    m2 = np.zeros((n, size, size), np.float32)
    m1[:, 4:30, 6:28] = 1
    m2[:, 34:60, 30:62] = 1
    batch = {'rgb': torch.from_numpy(rng.randn(n, size, size, 3).astype(
                 np.float32)),
             'modal1': torch.from_numpy(m1), 'modal2': torch.from_numpy(m2),
             'depth_order': torch.tensor([0, 1]),
             'is_overlap': torch.tensor([0, 0]),
             'occ_order': torch.zeros(n, 2)}
    opt = TO.SGD(0.9, m['weight_decay'])
    step = TST.build_train_step(
        TA.make_loss('InstaDepthNet_od', get_backbone('InstaDepthNet_od'),
                     cfg, m), opt)
    lr = 1.0
    new, _, _, logs = step(p, s, opt.init(p), batch, lr)
    assert np.isfinite(float(logs['loss']))
    for a, b in zip(tree_leaves(p['oo']), tree_leaves(new['oo'])):
        want = a - lr * (m['weight_decay'] * a)
        assert torch.equal(b, want)
        assert not a.any() or not torch.equal(a, b)
    moved = [not torch.equal(a, b) for a, b in zip(
        tree_leaves(p['trunk']), tree_leaves(new['trunk']))]
    assert all(moved)


def test_chip_smoke_violation_pixels():
    """chip_smoke.py's phase 9 counts the flipped pixels of the violation
    count from `violation_pixels`: its pixels sum to the loss's count."""
    sys.path.insert(0, str(REPO))
    import chip_smoke as CS
    from instaorder_tpu_torch import losses as TL
    rng = np.random.RandomState(0)
    n, h, w = 6, 20, 24
    d1 = torch.from_numpy(np.maximum(rng.randn(n, h, w), 0).astype(
        np.float32))
    d2 = torch.from_numpy(np.maximum(rng.randn(n, h, w), 0).astype(
        np.float32))
    e1 = torch.from_numpy(rng.rand(n, h, w) > 0.5)
    e2 = torch.from_numpy(rng.rand(n, h, w) > 0.4)
    order = torch.tensor([0, 1, 2, 0, 1, 0])
    distinct = torch.tensor([True, True, True, False, True, True])
    px = CS.violation_pixels(torch, d1, d2, e1, e2, order, distinct)
    count = TL.disparity_order_violations(d1, d2, e1, e2, order, distinct)
    assert px.shape == (4, n, h, w) and int(px.sum()) == int(count) > 0
    # each mask holds the other's threshold pixel: those ties are exact
    assert CS.violation_near(torch, d1, d2, e1 | e2, e1 | e2, distinct) == 0
