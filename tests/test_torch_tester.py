"""The port's Tester (instaorder_tpu_torch/eval/tester.py) against the
JAX package's on the CPU.

Both run on the same fixtures (written by the JAX package's
data/synthetic.py: InstaOrder, COCOA and KINS) and the same checkpoint
(written by the JAX package's save_state: resnet50_cls with
layers_override (1, 1, 1, 1), 5-channel stem, kaiming init from a
seed, the heads centred and scaled by chip_smoke.centre_heads so that
the decisions depend on the pair). Each image's matrices are captured by
wrapping the Testers (chip_smoke.record_tester). Bars: ground truth and
heuristic matrices equal everywhere; model matrices equal at every sure
cell of JAX's outputs (chip_smoke.sure_cells: the sigmoid or argmax
decision more than 1e-2 from flipping); recall / precision / F1 /
WHDR_* within 1e-12 and the summary scalars written (wandb's offline
history) equal wherever no cell differs, which holds where every cell
is sure.
"""

import glob
import json
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest

from instaorder_tpu.core import checkpoint as JCK
from instaorder_tpu.data import synthetic as JS
from instaorder_tpu.eval.tester import Tester as JTester
from instaorder_tpu.models.registry import get_backbone as jget

from instaorder_tpu_torch.eval.tester import Tester as TTester

from test_torch_train_step import one_torch_thread  # noqa: F401 (a fixture)
import torch_threads  # noqa: F401 (the suite's torch thread cap)

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke as CS  # noqa: E402

SIZE = 64
LAYERS = (1, 1, 1, 1)
STEP = 1234


@pytest.fixture(scope='module')
def fixtures(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('fixtures'))
    insta, _, img = JS.make_instaorder_fixture(root)
    return {'InstaOrder': (insta, img),
            'COCOA': JS.make_cocoa_fixture(root),
            'KINS': JS.make_kins_fixture(root)}


OCC = ('SupOcclusionOrderDataset', 'patch')
DEPTH = ('SupDepthOrderDataset', 'resize')
DUAL = ('SupDepthOccOrderDataset', 'resize')
# (name, dataset, algo, classes, (trainval_dataset, mode), order_method,
#  pairs, zd)
RUNS = [
    ('instaorder_o', 'InstaOrder', 'InstaOrderNet_o', 2, OCC, '', 'all', 0),
    ('instaorder_o_nbor_zd', 'InstaOrder', 'InstaOrderNet_o', 2, OCC, '',
     'nbor', 1),
    ('ordernet', 'InstaOrder', 'OrderNet', 3, OCC, '', 'all', 0),
    ('ordernet_ext', 'InstaOrder', 'OrderNet', 4, OCC, '', 'all', 0),
    ('depth', 'InstaOrder', 'InstaOrderNet_d', 3, DEPTH, '', 'all', 0),
    ('depth_nbor', 'InstaOrder', 'InstaOrderNet_d', 3, DEPTH, '', 'nbor',
     0),
    ('dual', 'InstaOrder', 'InstaOrderNet_od', [2, 3], DUAL, '', 'all', 0),
    ('cocoa_o', 'COCOA', 'InstaOrderNet_o', 2, OCC, '', 'all', 0),
    ('cocoa_ordernet', 'COCOA', 'OrderNet', 3, OCC, '', 'all', 0),
    ('kins_o', 'KINS', 'InstaOrderNet_o', 2, OCC, '', 'all', 0),
    ('kins_o_nbor', 'KINS', 'InstaOrderNet_o', 2, OCC, '', 'nbor', 0),
    *((f'instaorder_occ_{m}', 'InstaOrder', 'InstaOrderNet_o', 2, OCC, m,
       'all', 0) for m in ('area', 'yaxis', 'hull')),
    *((f'instaorder_depth_{m}', 'InstaOrder', 'InstaOrderNet_d', 3, DEPTH,
       m, 'all', 0) for m in ('area', 'yaxis')),
    *((f'kins_{m}', 'KINS', 'InstaOrderNet_o', 2, OCC, m, 'all', 0)
      for m in ('area', 'yaxis', 'hull')),
    ('cocoa_yaxis', 'COCOA', 'InstaOrderNet_o', 2, OCC, 'yaxis', 'all', 0),
]


def make_args(fixtures, ckpts, out_dir, dataset, algo, classes, tv, method,
              pairs, zd, load_model=None):
    ann, img = fixtures[dataset]
    a = types.SimpleNamespace()
    a.model = {'algo': algo, 'backbone_arch': 'resnet50_cls',
               'backbone_param': {'in_channels': 5, 'num_classes': classes,
                                  'layers_override': LAYERS},
               'use_rgb': True}
    a.data = {'dataset': dataset, 'val_annot_file': ann,
              'val_image_root': img, 'trainval_dataset': tv[0],
              'input_size': SIZE, 'patch_or_image': tv[1],
              'enlarge_box': 3.0, 'use_category': False,
              'remove_occ_bidirec': 0, 'remove_depth_overlap': 0}
    # wandb: True without the client writes wandb's offline history,
    # where the summary scalars of both Testers are read back
    a.trainer = {'wandb': True}
    a.order_method = method
    a.pairs = pairs
    a.zd = zd
    a.load_model = load_model or (None if method
                                  else ckpts[str(classes), tv[1]])
    a.out_dir = str(out_dir)
    return a


@pytest.fixture(scope='module')
def ckpts(fixtures, tmp_path_factory):
    """JAX-written checkpoints by (head, mode): each net from its own
    seed (kaiming), its heads centred on the InstaOrder fixture's pairs
    (chip_smoke.centre_heads, the logits from the port's Tester on the
    same weights)."""
    root = tmp_path_factory.mktemp('ckpts')
    out = {}
    for seed, (algo, classes, tv) in enumerate((
            ('InstaOrderNet_o', 2, OCC), ('OrderNet', 3, OCC),
            ('OrderNet', 4, OCC), ('InstaOrderNet_d', 3, DEPTH),
            ('InstaOrderNet_od', [2, 3], DUAL))):
        params, stats, _ = jget('resnet50_cls')['init'](
            jax.random.PRNGKey(seed), in_channels=5, num_classes=classes,
            weight_init='kaiming_out', layers_override=LAYERS)
        params = jax.tree_util.tree_map(np.asarray, params)
        stats = jax.tree_util.tree_map(np.asarray, stats)
        raw = JCK.save_state(str(root / f'raw{seed}'), 0, params, stats)
        t = TTester(make_args(fixtures, None, root, 'InstaOrder', algo,
                              classes, tv, '', 'all', 0, load_model=raw),
                    logger=Quiet(), device='cpu')
        params = CS.centre_heads(params, CS.head_logits(t, 4))
        out[str(classes), tv[1]] = JCK.save_state(str(root / f'c{seed}'),
                                                  STEP, params, stats)
    return out


def history(out_dir):
    (path,) = glob.glob(f'{out_dir}/wandb/run-*/history.jsonl')
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    for r in recs:
        r.pop('_timestamp')
    return recs


class Quiet:
    def info(self, *a, **k):
        pass


@pytest.mark.parametrize('run', RUNS, ids=[r[0] for r in RUNS])
def test_tester_matches_jax(run, fixtures, ckpts, tmp_path):
    name, dataset, algo, classes, tv, method, pairs, zd = run
    res, recs = {}, {}
    for who, cls, kw in (('jax', JTester, {}),
                         ('port', TTester, {'device': 'cpu'})):
        args = make_args(fixtures, ckpts, tmp_path / who, dataset, algo,
                         classes, tv, method, pairs, zd)
        t = cls(args, logger=Quiet(), **kw)
        recs[who] = CS.record_tester(t)
        res[who] = t.run()
        t.summary.close()
        if not method:
            assert t.curr_step == STEP
    n_images = len(recs['jax'])
    assert n_images == {'InstaOrder': 4, 'COCOA': 3, 'KINS': 3}[dataset]
    sure, unsure, differ = CS.compare_tester_runs(name, algo, recs['port'],
                                                  recs['jax'])
    if not method:
        assert all('out' in r for r in recs['port'] + recs['jax'])
        assert sure > 0, (sure, unsure)
    # the metrics are a function of the matrices and the ground truth:
    # held wherever no cell differs (every cell sure, or the unsure ones
    # decided alike)
    if differ == 0:
        assert res['port'].keys() == res['jax'].keys()
        for k in res['jax']:
            assert abs(res['port'][k] - res['jax'][k]) <= 1e-12, k
        assert history(tmp_path / 'port') == history(tmp_path / 'jax')
    if tv[0] != 'SupOcclusionOrderDataset':
        assert any(k.startswith('WHDR_') for k in res['jax'])
