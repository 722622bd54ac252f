"""The port's Trainer and train CLI on the CPU, and checkpoint interop
with the JAX package's Trainer.

  * the end-to-end flow of JAX's tests/test_trainer_e2e.py on
    device='cpu': train 4 steps, checkpoint, resume (start_iter 4,
    params equal), train to 6, validate, and the port's Tester on the
    step-6 checkpoint;
  * checkpoint interop with JAX's Trainer: test_torch_trainer_interop.py;
  * the failure paths: a non-finite loss, no GPU, the CLI's refusals;
  * chip_smoke.py's training configurations: the experiment YAMLs'.
"""

import os
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from instaorder_tpu_torch.cli import train as cli_train
from instaorder_tpu_torch.cli.config import load_config
from instaorder_tpu_torch.core.nn import tree_leaves
from instaorder_tpu_torch.data import synthetic
from instaorder_tpu_torch.eval.tester import Tester
from instaorder_tpu_torch.train.trainer import Trainer

from test_torch_train_step import one_torch_thread  # noqa: F401 (a fixture)

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke as CS  # noqa: E402


@pytest.fixture(scope='module')
def fixture(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('trainer'))
    insta, _, img = synthetic.make_instaorder_fixture(root)
    return {'root': root, 'insta': insta, 'img': img}


def make_args(fixture, total_iter=4):
    """JAX's test_trainer_e2e.make_args (resnet50_cls, layers (1,1,1,1),
    64x64, batch 2)."""
    args = types.SimpleNamespace()
    args.model = {
        'algo': 'InstaOrderNet_o', 'total_iter': total_iter,
        'lr_steps': [2], 'lr_mults': [0.1], 'lr': 1e-3,
        'weight_decay': 1e-4, 'optim': 'SGD',
        'warmup_lr': [], 'warmup_steps': [],
        'backbone_arch': 'resnet50_cls',
        'backbone_param': {'in_channels': 5, 'num_classes': 2,
                           'layers_override': (1, 1, 1, 1)},
        'use_rgb': True,
    }
    args.data = {
        'dataset': 'InstaOrder',
        'trainval_dataset': 'SupOcclusionOrderDataset',
        'train_image_root': fixture['img'],
        'train_annot_file': fixture['insta'],
        'val_image_root': fixture['img'],
        'val_annot_file': fixture['insta'],
        'input_size': 64, 'enlarge_box': 3.0,
        'base_aug': {'flip': True, 'shift': [-0.2, 0.2],
                     'scale': [0.8, 1.2]},
        'load_rgb': True, 'batch_size': 2, 'batch_size_val': 2,
        'workers': 2, 'patch_or_image': 'patch',
        'remove_occ_bidirec': 0, 'use_category': False,
        'base_dir': fixture['root'],
    }
    args.trainer = {'initial_val': False, 'val_freq': 1000, 'val_iter': 1,
                    'print_freq': 2, 'save_freq': 1000,
                    'loss_record': ['loss'], 'exp_name': 'e2e_test'}
    args.seed = 0
    return args


def test_train_checkpoint_resume_eval(fixture, tmp_path):
    out = str(tmp_path / 'run1')
    t = Trainer(make_args(fixture), device='cpu', out_dir=out)
    assert t.folder == out and t.device.type == 'cpu'
    t.train()
    assert t.curr_step == 4
    ckpts = os.listdir(os.path.join(out, 'checkpoints'))
    assert 'ckpt_iter_4.ckpt' in ckpts
    assert len(t.btime.history) == len(t.dtime.history) == 4

    t2 = Trainer(make_args(fixture, total_iter=6), device='cpu',
                 out_dir=str(tmp_path / 'run2'))
    t2.load(os.path.join(out, 'checkpoints', 'ckpt_iter_4.ckpt'),
            resume=True)
    assert t2.start_iter == 4
    for x, y in zip(tree_leaves(t.params), tree_leaves(t2.params)):
        assert y.dtype == torch.float32 and y.device.type == 'cpu'
        assert torch.equal(x, y)
    for x, y in zip(tree_leaves(t.opt_state), tree_leaves(t2.opt_state)):
        assert torch.equal(x, y)
    t2.train()
    assert t2.curr_step == 6
    val = t2.validate()
    assert np.isfinite(val['loss'])

    args = make_args(fixture)
    args.order_method = ''
    args.pairs = 'all'
    args.zd = 0
    args.load_model = os.path.join(str(tmp_path / 'run2'), 'checkpoints',
                                   'ckpt_iter_6.ckpt')
    args.out_dir = str(tmp_path / 'eval')
    tester = Tester(args, device='cpu')
    res = tester.run()
    assert tester.curr_step == 6
    assert np.isfinite(res['f1'])


def test_nan_loss_fails_fast(fixture, tmp_path):
    args = make_args(fixture, total_iter=2)
    args.trainer['print_freq'] = 1
    t = Trainer(args, device='cpu', out_dir=str(tmp_path / 'nan'))
    real = t.train_step

    def poisoned(*a):
        params, stats, opt_state, logs = real(*a)
        return params, stats, opt_state, {'loss': torch.tensor(np.nan)}

    t.train_step = poisoned
    with pytest.raises(FloatingPointError, match='iter 1'):
        t.train()


def test_trainer_needs_a_gpu_by_default(fixture, tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a GPU is present')
    with pytest.raises(RuntimeError, match='no GPU'):
        Trainer(make_args(fixture), out_dir=str(tmp_path / 'gpu'))
    # load_pretrain: a torch state_dict (the reference's .pth.tar layout)
    # merged onto the init through compat/torch_convert
    from torch_ref import TorchResNetCls
    from instaorder_tpu_torch.compat.torch_convert import (
        resnet_from_torch_state_dict)
    tm = TorchResNetCls(layers=(1, 1, 1, 1), in_channels=5, num_classes=2)
    pth = str(tmp_path / 'pretrain.pth.tar')
    torch.save({'step': 0, 'state_dict': {f'module.{k}': v for k, v in
                                          tm.state_dict().items()}}, pth)
    args = make_args(fixture)
    args.model['load_pretrain'] = pth
    t = Trainer(args, device='cpu', out_dir=str(tmp_path / 'pre'))
    want, wstats = resnet_from_torch_state_dict(tm.state_dict(), t.net_cfg)
    for got, ref in ((t.params, want), (t.stats, wstats)):
        assert len(tree_leaves(got)) == len(tree_leaves(ref))
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got),
                                                     tree_leaves(ref)))


@pytest.fixture()
def config_file(fixture, tmp_path):
    cfg = tmp_path / 'config.yaml'
    f = fixture
    cfg.write_text(
        'model:\n  algo: InstaOrderNet_o\n  total_iter: 1\n'
        '  lr: 0.001\n  lr_steps: [1]\n  lr_mults: [0.1]\n  optim: SGD\n'
        '  weight_decay: 0.0001\n  backbone_arch: resnet50_cls\n'
        '  backbone_param:\n    in_channels: 5\n    num_classes: 2\n'
        '    layers_override: [1, 1, 1, 1]\n  use_rgb: true\n'
        'data:\n  dataset: InstaOrder\n'
        '  trainval_dataset: SupOcclusionOrderDataset\n'
        f'  train_image_root: {f["img"]}\n'
        f'  train_annot_file: {f["insta"]}\n'
        f'  val_image_root: {f["img"]}\n'
        f'  val_annot_file: {f["insta"]}\n'
        '  input_size: 64\n  enlarge_box: 3.0\n'
        '  base_aug: {flip: true, shift: [-0.2, 0.2], scale: [0.8, 1.2]}\n'
        '  load_rgb: true\n  batch_size: 2\n  workers: 1\n'
        '  patch_or_image: patch\n  remove_occ_bidirec: 0\n'
        'trainer:\n  exp_name: cli\n  val_iter: 1\n  print_freq: 1\n')
    return str(cfg)


def test_cli(config_file, tmp_path):
    out = str(tmp_path / 'cli')
    base = ['--config', config_file, '--out-dir', out, '--device', 'cpu']
    t = cli_train.main(base + ['--seed', '7', '--extract', '--evaluate',
                               '--evaluate-save'])
    assert t.curr_step == 1 and t.args.seed == 7
    assert os.path.isfile(os.path.join(out, 'checkpoints',
                                       'ckpt_iter_1.ckpt'))
    # --auto-resume picks up the latest checkpoint of the run dir
    cfg = Path(config_file)
    cfg.write_text(cfg.read_text().replace('total_iter: 1', 'total_iter: 2'))
    t = cli_train.main(base + ['--auto-resume'])
    assert t.start_iter == 1 and t.curr_step == 2
    # --load-model / --load-iter without --resume: weights only
    t = cli_train.main(base + ['--load-model',
                               os.path.join(out, 'checkpoints'),
                               '--load-iter', '2', '--validate'])
    assert t.start_iter == 0
    # --load_pretrain: a torch state_dict merged onto the init (a missing
    # file fails in torch.load, as in the JAX package)
    from torch_ref import TorchResNetCls
    tm = TorchResNetCls(layers=(1, 1, 1, 1), in_channels=5, num_classes=2)
    pth = str(tmp_path / 'a.pth')
    torch.save(tm.state_dict(), pth)
    t = cli_train.main(base + ['--load_pretrain', pth, '--validate'])
    assert torch.equal(t.params['layer2'][0]['conv2']['w'],
                       tm.layer2[0].conv2.weight.permute(2, 3, 1, 0))
    with pytest.raises(FileNotFoundError):
        cli_train.main(base + ['--load_pretrain', '/x/a.pth'])
    # the refusals
    for extra, err in ((['--n-devices', '2'], NotImplementedError),
                       (['--multihost'], NotImplementedError)):
        with pytest.raises(err):
            cli_train.main(base + extra)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no GPU'):
            cli_train.main(['--config', config_file, '--out-dir', out])


@pytest.mark.parametrize('name', CS.TRAIN_NETS)
def test_chip_smoke_train_args(name, fixture):
    """chip_smoke.py trains each net at its experiment YAML's settings:
    only the paths (on the fixture), total_iter, the asked keys, the
    telemetry and initial validation and the occlusion datasets'
    validation batch differ."""
    insta, img = fixture['insta'], fixture['img']
    cfg = load_config(str(REPO / 'experiments' / 'InstaOrder' / name /
                          'config.yaml'))
    a = CS.train_args(name, (insta, img), 3, {'loader_mode': 'process'},
                      print_freq=1)
    paths = {'train_annot_file': insta, 'val_annot_file': insta,
             'train_image_root': img, 'val_image_root': img}
    assert a.model == dict(cfg.model, total_iter=3)
    assert a.trainer == dict(cfg.trainer, print_freq=1, tensorboard=False,
                             wandb=False, initial_val=False)
    want = dict(cfg.data, **paths, loader_mode='process')
    if want['trainval_dataset'] == 'SupOcclusionOrderDataset':
        want['batch_size_val'] = CS.TESTER_IMAGES
    assert a.data == want and a.seed == 0
