"""The port's disparity evaluation against the JAX package on the CPU:
`decode.midas_region_depth_order`, `DisparityOrderPredictor` (a gradient
forward and a trimmed MidasNet), `eval_diw` / `eval_dense_depth` (JAX's
fake readers, and the port's fixtures), the DIW / KITTI / NYU readers
(every value equal), the 16-bit depth PNG decode against cv2, the
Tester's disparity route against JAX's Tester, `cli/test_disp`, and the
routes where the JAX package fails, which raise ValueError in the port.

The nets are trimmed (features 8, one block a stage) and drawn by the
port (seed 0), with out_conv3's bias set so that the disparity is
positive; JAX runs the same trees (convert.to_numpy). Both sides' Testers
get them through a monkeypatched make_disp_forward.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instaorder_tpu.data import readers as JR
from instaorder_tpu.eval import decode as JD
from instaorder_tpu.eval import disp as JDISP
from instaorder_tpu.eval import pipeline as JPL
from instaorder_tpu.eval import tester as JT
from instaorder_tpu.models import midas as jmidas

from instaorder_tpu_torch import convert
from instaorder_tpu_torch.cli import test_disp as tcli_disp
from instaorder_tpu_torch.data import image_io
from instaorder_tpu_torch.data import readers as TR
from instaorder_tpu_torch.data import synthetic as TS
from instaorder_tpu_torch.eval import decode as TD
from instaorder_tpu_torch.eval import disp as TDISP
from instaorder_tpu_torch.eval import pipeline as TPL
from instaorder_tpu_torch.eval import tester as TT
from instaorder_tpu_torch.models import midas as tmidas

from test_disp_eval import (FakeDIWReader, FakeKITTIReader,
                            gradient_disp_forward)
from torch_ref import TorchMidasOracle

SMALL = (1, 1, 1, 1)
MAKE_DISP_FORWARD = TDISP.make_disp_forward     # before any monkeypatch
MEAN = [0.485, 0.456, 0.406]
STD = [0.229, 0.224, 0.225]
SIZE = 64


def quiet(*a):
    pass


def trimmed(variant='midas', features=8):
    """(port params, stats, cfg) of a trimmed net, seed 0, out_conv3's
    bias 0.5."""
    p, s, cfg = tmidas.init(torch.Generator().manual_seed(0),
                            features=features, variant=variant,
                            trunk_layers=SMALL, branch_layers=SMALL)
    p['out_conv3']['b'] += 0.5
    return p, s, cfg


@pytest.fixture(scope='module')
def net():
    p, s, cfg = trimmed()
    jp, js = convert.to_numpy(p), convert.to_numpy(s)

    def tfwd(x):
        with torch.no_grad():
            return tmidas.apply_disp(p, s, cfg, torch.as_tensor(
                x, dtype=torch.float32))
    jfwd = jax.jit(lambda x: jmidas.apply(jp, js, cfg, x)[0])
    return types.SimpleNamespace(p=p, s=s, cfg=cfg, jp=jp, js=js,
                                 tfwd=tfwd, jfwd=jfwd)


def j_gradient(x):
    """tests/test_eval_pipeline.py's forward: a disparity falling with y
    at the input's size (higher masks are closer)."""
    h = w = x.shape[1]
    gy = np.linspace(1.0, 0.1, h, dtype=np.float32)
    return np.tile(gy[None, :, None], (x.shape[0], 1, w))


def t_gradient(x):
    return torch.from_numpy(j_gradient(x))


def t_gradient_384(x):
    """tests/test_disp_eval.py's forward (always 384^2), as a tensor."""
    return torch.from_numpy(gradient_disp_forward(np.zeros(x.shape)))


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('method', ['median', 'mean'])
def test_midas_region_depth_order_matches_jax(method):
    rng = np.random.RandomState(0)
    depth = rng.uniform(0.5, 20.0, (40, 50)).astype(np.float32)
    masks = np.zeros((5, 40, 50), np.float32)
    masks[0, 2:15, 3:20] = 1
    masks[1, 20:38, 10:45] = 1
    masks[2, 5:9, 30:33] = 1
    masks[3] = rng.rand(40, 50) > 0.7
    # masks[4] stays empty: its region depth is NaN, every pair equal
    want = np.asarray([[JD.midas_region_depth_order(
        jnp.asarray(depth), jnp.asarray(masks[i]), jnp.asarray(masks[j]),
        method) for j in range(5)] for i in range(5)])
    got = np.asarray([[int(TD.midas_region_depth_order(
        torch.from_numpy(depth), torch.from_numpy(masks[i]),
        torch.from_numpy(masks[j]), method)) for j in range(5)]
        for i in range(5)])
    np.testing.assert_array_equal(got, want)
    assert (got[4] == 2).all() and (got[:, 4] == 2).all()
    assert set(got[:4, :4][~np.eye(4, dtype=bool)]) == {0, 1}
    d = TD.region_depths(torch.from_numpy(depth),
                         torch.from_numpy(masks > 0.5), method).numpy()
    assert np.isnan(d[4]) and np.isfinite(d[:4]).all()


# ---------------------------------------------------------------------------
# DisparityOrderPredictor
# ---------------------------------------------------------------------------

def scene(seed=1, h=100, w=120):
    """An image and six masks at distinct heights, plus one single-pixel
    mask on a row and column that the nearest resize to SIZE skips: it
    vanishes, its region depth is NaN and its pairs come out equal."""
    rng = np.random.RandomState(seed)
    image = rng.randint(0, 256, (h, w, 3)).astype(np.float32)
    masks = np.zeros((7, h, w), np.float32)
    for k in range(6):
        y0 = 4 + 15 * k
        masks[k, y0:y0 + 10 + k, 5 + 9 * k:40 + 9 * k] = 1
    masks[2, 30:50, 60:70] = 1          # 2 touches 3: a `nbor` pair
    from instaorder_tpu_torch.ops.resize import nearest_indices
    ys = sorted(set(range(h)) - set(nearest_indices(h, SIZE)))
    xs = sorted(set(range(w)) - set(nearest_indices(w, SIZE)))
    masks[6, ys[0], xs[0]] = 1
    return image, masks


@pytest.mark.parametrize('select', ['median', 'mean'])
@pytest.mark.parametrize('pairs', ['all', 'nbor'])
@pytest.mark.parametrize('fwd', ['gradient', 'midas'])
def test_disparity_predictor_matches_jax(select, pairs, fwd, net):
    image, masks = scene()
    tf, jf = ((t_gradient, j_gradient) if fwd == 'gradient'
              else (net.tfwd, net.jfwd))
    jpred = JPL.DisparityOrderPredictor(jf, select, input_size=SIZE)
    tpred = TPL.DisparityOrderPredictor(tf, select, input_size=SIZE,
                                        device='cpu')
    want, jdisp = jpred.infer_depth_order(image, masks, pairs=pairs,
                                          return_disp=True)
    got, tdisp = tpred.infer_depth_order(image, masks, pairs=pairs,
                                         return_disp=True)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, tpred.infer_depth_order(image, masks, pairs=pairs))
    assert np.abs(tdisp - np.asarray(jdisp)).max() <= 1e-5 * np.abs(
        np.asarray(jdisp)).max()
    # the vanished instance: equal to every other (JAX's NaN rule)
    others = [k for k in range(6) if pairs == 'all' or got[6, k]]
    assert all(got[6, k] == 2 and got[k, 6] == 2 for k in others)
    decided = got[:6, :6][~np.eye(6, dtype=bool)]
    if pairs == 'all':
        assert set(decided) == {0, 1}
    else:
        assert got[2, 3] + got[3, 2] == 1 and (decided == 0).sum() > 20


# ---------------------------------------------------------------------------
# eval_diw / eval_dense_depth
# ---------------------------------------------------------------------------

def test_eval_diw_matches_jax_on_fake_reader():
    reader = FakeDIWReader()
    for k, ordinal in enumerate(('<', '>')):
        r = FakeDIWReader()
        r.samples[0] = (r.samples[0][0], r.samples[0][1],
                        [[10, 10], [50, 50], ordinal], 'x')
        want = JDISP.eval_diw(gradient_disp_forward, r, log=quiet)
        got = TDISP.eval_diw(t_gradient_384, r, log=quiet)
        assert got == want and got['whdr'] == 50.0 * k
    assert TDISP.eval_diw(t_gradient_384, reader, n_samples=1, log=quiet) == {
        'whdr': 0.0, 'n': 1}


@pytest.mark.parametrize('gt', ['constant', 'ramp', 'missing'])
def test_eval_dense_depth_matches_jax_on_fake_reader(gt):
    rng = np.random.RandomState(7)
    maps = {'constant': np.full((362, 1224), 5.0, np.float32),
            'ramp': np.where(rng.rand(362, 1224) < 0.3, np.linspace(
                1, 90, 362, dtype=np.float32)[:, None], 0).astype(
                    np.float32)}

    def read_gt(name):
        return maps.get(gt)

    def fwd(x):
        r = np.random.RandomState(int(np.abs(x).sum()) % 1000)
        return r.uniform(0.1, 2.0, (x.shape[0], 352, 1216)).astype(
            np.float32)
    want = JDISP.eval_dense_depth(fwd, FakeKITTIReader(), 'kitti',
                                  read_gt_depth=read_gt, log=quiet)
    got = TDISP.eval_dense_depth(lambda x: torch.from_numpy(fwd(x)),
                                 FakeKITTIReader(), 'kitti',
                                 read_gt_depth=read_gt, log=quiet)
    assert sorted(got) == sorted(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12 * max(abs(want[k]), 1), k
    with pytest.raises(NotImplementedError, match='queue 1 item 4'):
        TDISP.eval_dense_depth(fwd, FakeKITTIReader(), 'kitti',
                               read_gt_depth=read_gt, save_dir='x')


@pytest.fixture(scope='module')
def disp_fixtures(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('disp'))
    return {'diw': TS.make_diw_fixture(root + '/diw'),
            'kitti': TS.make_kitti_fixture(root + '/kitti'),
            'nyu': TS.make_nyu_fixture(root + '/nyu')}


def image_disp(x):
    """A disparity that depends on the image (numpy, for both sides):
    the normalised green channel, shifted positive."""
    return (x[..., 1] + 3.0).astype(np.float32)


def test_readers_match_jax(disp_fixtures):
    for name, jcls, tcls in (('diw', JR.DIWReader, TR.DIWReader),
                             ('kitti', JR.KITTIReader, TR.KITTIReader),
                             ('nyu', JR.NYUReader, TR.NYUReader)):
        jr = jcls(*disp_fixtures[name], MEAN, STD)
        tr = tcls(*disp_fixtures[name], MEAN, STD)
        assert len(tr) == len(jr) == {'diw': 8, 'kitti': 4, 'nyu': 2}[name]
        for i in range(len(jr)):
            for g, w in zip(tr[i], jr[i]):
                if isinstance(w, np.ndarray):
                    assert g.dtype == w.dtype and g.shape == w.shape
                    np.testing.assert_array_equal(g, w)
                else:
                    assert g == w, (name, i)


def test_depth_png_matches_cv2(disp_fixtures, tmp_path):
    import cv2
    for name in ('kitti', 'nyu'):
        reader = TR.KITTIReader if name == 'kitti' else TR.NYUReader
        for i in range(2):
            path = reader(*disp_fixtures[name], MEAN, STD)[i][2]
            raw = cv2.imread(path, -1)
            assert raw.dtype == np.uint16 and (raw == 0).any()
            np.testing.assert_array_equal(image_io.read_depth_png(path),
                                          raw.astype(np.float32) / 256.0)
    # cv2's own writer filters its rows
    a = np.random.RandomState(0).randint(0, 65536, (31, 47)).astype(
        np.uint16)
    cv2.imwrite(str(tmp_path / 'a.png'), a)
    np.testing.assert_array_equal(image_io.read_depth_png(
        str(tmp_path / 'a.png')), a.astype(np.float32) / 256.0)
    assert image_io.read_depth_png(str(tmp_path / 'none.png')) is None


def test_eval_on_fixtures_matches_jax(disp_fixtures):
    """eval_diw and eval_dense_depth on the port's fixtures, each side's
    readers and default ground-truth reader (JAX: cv2; the port:
    image_io.read_depth_png)."""
    jr = JR.DIWReader(*disp_fixtures['diw'], MEAN, STD)
    tr = TR.DIWReader(*disp_fixtures['diw'], MEAN, STD)
    want = JDISP.eval_diw(image_disp, jr, log=quiet)
    assert TDISP.eval_diw(image_disp, tr, log=quiet) == want
    assert want['n'] == 8 and 0 < want['whdr'] < 100
    for name in ('kitti', 'nyu'):
        jcls = JR.KITTIReader if name == 'kitti' else JR.NYUReader
        tcls = TR.KITTIReader if name == 'kitti' else TR.NYUReader
        want = JDISP.eval_dense_depth(
            image_disp, jcls(*disp_fixtures[name], MEAN, STD), name,
            log=quiet)
        got = TDISP.eval_dense_depth(
            lambda x: torch.from_numpy(image_disp(x)),
            tcls(*disp_fixtures[name], MEAN, STD), name, log=quiet)
        assert sorted(got) == sorted(want) and len(want) == 9
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-5 * abs(want[k]), (name, k)


# ---------------------------------------------------------------------------
# the Tester's disparity route, cli/test_disp, and the JAX gaps
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def insta(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('insta'))
    ann, _, img = TS.make_instaorder_fixture(root, n_images=3,
                                             n_instances=5)
    return ann, img, root


def disp_args(insta, algo, select, pairs,
                trainval='SupDepthOrderDataset'):
    ann, img, root = insta
    return types.SimpleNamespace(
        model={'algo': algo, 'backbone_arch': None},
        data={'dataset': 'InstaOrder', 'val_annot_file': ann,
              'val_image_root': img, 'input_size': SIZE,
              'trainval_dataset': trainval, 'patch_or_image': 'resize'},
        trainer={}, out_dir=root, order_method='', pairs=pairs, zd=0,
        load_model=None, disp_select_method=select, save_pngs=0)


@pytest.fixture()
def patched(net, monkeypatch):
    """Both packages' make_disp_forward on the trimmed net: JAX's own
    _disp_forward_fn on the numpy trees, the port's forward on its own."""
    def jmake(algo, load_model=None, features=256):
        cfg = dict(net.cfg, variant=TDISP.ALGO_VARIANTS[algo])
        if cfg['variant'] == 'midas':
            return JDISP._disp_forward_fn(jmidas.apply, cfg, net.jp,
                                          net.js, algo)
        # JAX's InstaDepthNet forward runs its branch on zero masks
        p, s, c = trimmed(cfg['variant'])
        return JDISP._disp_forward_fn(jmidas.apply, c, convert.to_numpy(p),
                                      convert.to_numpy(s), algo)

    def tmake(algo, load_model=None, features=256, device=None):
        p, s, c = trimmed(TDISP.ALGO_VARIANTS[algo])
        return lambda x: tmidas.apply_disp(p, s, c, torch.as_tensor(
            x, dtype=torch.float32))
    monkeypatch.setattr(JDISP, 'make_disp_forward', jmake)
    monkeypatch.setattr(TDISP, 'make_disp_forward', tmake)


@pytest.mark.parametrize('algo,select,pairs', [
    ('midas_pretrained', '', 'all'),
    ('InstaDepthNet_d', 'median', 'all'),
    ('InstaDepthNet_d', 'median', 'nbor'),
    ('InstaDepthNet_d', 'mean', 'all')])
def test_tester_disparity_route_matches_jax(insta, patched, algo, select,
                                            pairs):
    args = disp_args(insta, algo, select, pairs)
    want = JT.Tester(args).run()
    t = TT.Tester(args, device='cpu')
    got = t.run()
    assert isinstance(t.predictor, TPL.DisparityOrderPredictor)
    assert t.predictor.select == (select or 'median')
    assert got == want and len(got) == 9


def test_cli_test_disp(disp_fixtures, patched, tmp_path, capsys,
                       monkeypatch):
    import yaml
    for name, exp in (('diw', 'DIW/midas_pretrained'),
                      ('kitti', 'kitti/InstaDepthNet_d')):
        raw = yaml.safe_load(open(f'experiments/{exp}/config.yaml'))
        ann, root = disp_fixtures[name]
        raw['data'].update(base_dir='', val_annot_file=ann,
                           val_image_root=root)
        path = tmp_path / f'{name}.yaml'
        path.write_text(yaml.safe_dump(raw))
        got = tcli_disp.main(['--config', str(path), '--test_num', '2',
                              '--device', 'cpu'])
        assert capsys.readouterr().out.strip().splitlines()[-1] == str(got)
        fwd = TDISP.make_disp_forward(raw['model']['algo'])
        cls = TR.DIWReader if name == 'diw' else TR.KITTIReader
        reader = cls(ann, root, MEAN, STD)
        want = (TDISP.eval_diw(fwd, reader, 2, log=quiet) if name == 'diw'
                else TDISP.eval_dense_depth(fwd, reader, 'kitti', 2,
                                            log=quiet))
        assert got == want and got['n'] == 2
    # a torch .pt load_model through compat/torch_convert, held against
    # the torch module that wrote the state dict; make_disp_forward draws
    # the trimmed trunk here (its full depth costs ~80 s of a loaded CPU)
    real_init = tmidas.init
    monkeypatch.setattr(tmidas, 'init', lambda gen, **kw: real_init(
        gen, trunk_layers=SMALL, branch_layers=SMALL, **kw))
    oracle = TorchMidasOracle(trunk_layers=SMALL, features=8,
                              variant='midas').eval()
    x = np.random.RandomState(0).randn(1, SIZE, SIZE, 3).astype(np.float32)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2))
    last = oracle.scratch.output_conv[4]
    pre = []
    hook = last.register_forward_hook(lambda m, i, o: pre.append(o))
    with torch.no_grad():
        oracle(xt)
        hook.remove()
        last.bias -= pre[0].median()   # the disparity positive on ~half
    pt = str(tmp_path / 'model-f6b98070.pt')
    torch.save(oracle.state_dict(), pt)
    got = MAKE_DISP_FORWARD('midas_pretrained', pt, features=8,
                            device='cpu')(x).numpy()
    with torch.no_grad():
        want = oracle(xt).numpy()
    assert 0.2 < (want > 0).mean() and want.shape == got.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_jax_gap_routes_raise(insta, patched):
    # (1) an InstaDepthNet through the model route: JAX's OrderPredictor
    # feeds the 5-channel pair batch to the 3-channel trunk and fails
    p, s, cfg = trimmed('instadepthnet_od')
    jpred = JPL.OrderPredictor(jmidas.apply, cfg, convert.to_numpy(p),
                               convert.to_numpy(s), 'InstaDepthNet_od',
                               patch_or_image='resize', input_size=SIZE)
    image, masks = scene()
    bboxes = np.tile(np.array([[0, 0, 50, 50]], np.float32), (7, 1))
    with pytest.raises((ValueError, TypeError)):
        jpred.infer_occ_depth_order(image, masks, bboxes)
    for algo, trainval in (('InstaDepthNet_d', 'SupDepthOrderDataset'),
                           ('InstaDepthNet_od', 'SupDepthOccOrderDataset')):
        with pytest.raises(ValueError, match='disparity route only'):
            TT.Tester(disp_args(insta, algo, '', 'all', trainval),
                      device='cpu').run()
    # (2) the disparity route under SupDepthOccOrderDataset: JAX's
    # DisparityOrderPredictor has no infer_occ_depth_order
    args = disp_args(insta, 'InstaDepthNet_od', 'median', 'all',
                       'SupDepthOccOrderDataset')
    assert not hasattr(JPL.DisparityOrderPredictor, 'infer_occ_depth_order')
    with pytest.raises(AttributeError, match='infer_occ_depth_order'):
        JT.Tester(args).run()
    with pytest.raises(ValueError, match='infer_occ_depth_order'):
        TT.Tester(args, device='cpu').run()


def test_chip_smoke_disp_configs_match_yaml(tmp_path):
    """chip_smoke.py's phase 7 runs each MiDaS config at its experiment
    YAML's settings: the Tester's config is cli/config.load_config of the
    file, and each cli/test_disp config file differs from it only in the
    paths on the fixture, base_dir, the dataset (NYU reads the kitti
    file) and telemetry."""
    import sys
    from pathlib import Path
    from instaorder_tpu.cli import config as JCFG
    repo = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(repo))
    import chip_smoke as CS
    from instaorder_tpu_torch.cli.config import load_config

    def ref(cname):
        return JCFG.load_config(str(repo / 'experiments' / cname /
                                    'config.yaml'))
    for _, cname, select, pairs in CS.DISP_RUNS:
        want = ref(cname)
        assert CS.tester_disp_config(cname) == {
            'model': want.model, 'data': want.data, 'trainer': want.trainer}
        assert pairs in ('all', 'nbor') and select in ('', 'median', 'mean')
        assert (select == '') == (want.model['algo'] == 'midas_pretrained')
    for cname, dataset in (('DIW/midas_pretrained', 'diw'),
                           ('kitti/InstaDepthNet_d', 'kitti'),
                           ('kitti/InstaDepthNet_d', 'nyu')):
        want = ref(cname).raw
        got = load_config(CS.disp_config_file(str(tmp_path), cname,
                                              'ann.csv', 'img', dataset))
        assert got.model == want['model']
        assert got.trainer == dict(want['trainer'], tensorboard=False)
        assert got.data == dict(want['data'], base_dir='',
                                val_annot_file='ann.csv',
                                val_image_root='img', dataset=dataset)


def test_midas_io_matches_jax(tmp_path):
    from instaorder_tpu.utils import midas_io as jio
    from instaorder_tpu_torch.utils import midas_io as tio
    rng = np.random.RandomState(9)
    for shape in ((7, 9), (5, 6, 3)):
        img = rng.randn(*shape).astype(np.float32)
        tio.write_pfm(str(tmp_path / 't.pfm'), img, scale=2)
        jio.write_pfm(str(tmp_path / 'j.pfm'), img, scale=2)
        assert (tmp_path / 't.pfm').read_bytes() == \
            (tmp_path / 'j.pfm').read_bytes()
        got, scale = tio.read_pfm(str(tmp_path / 'j.pfm'))
        np.testing.assert_array_equal(got, img)
        assert scale == 2
    for x in (100.0, 383.9, 400.0, 15.9):
        for kw in ({}, {'max_val': 384}, {'min_val': 384}):
            assert (tio.constrain_to_multiple_of(x, **kw) ==
                    jio.constrain_to_multiple_of(x, **kw))
    for method in ('lower_bound', 'upper_bound', 'minimal'):
        for keep in (False, True):
            assert (tio.midas_resize_shape(480, 640, 384, 384, keep, method)
                    == jio.midas_resize_shape(480, 640, 384, 384, keep,
                                              method))
    d = rng.rand(4, 5)
    for a, b in zip(tio.disp_to_depth(d, 0.1, 80), jio.disp_to_depth(d, 0.1,
                                                                      80)):
        np.testing.assert_array_equal(a, b)
    chw = rng.randn(3, 4, 5)
    np.testing.assert_array_equal(tio.unnormalize(chw), jio.unnormalize(chw))
    img = (rng.rand(6, 7) * 10).astype(np.float32)
    tio.write_depth_png(str(tmp_path / 't.png'), img, bits=2)
    jio.write_depth_png(str(tmp_path / 'j.png'), img, bits=2)
    import cv2
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / 't.png'), -1),
                                  cv2.imread(str(tmp_path / 'j.png'), -1))
    cv2.imwrite(str(tmp_path / 'rgb.png'), (rng.rand(5, 6, 3) * 255).astype(
        np.uint8))
    np.testing.assert_array_equal(tio.read_image(str(tmp_path / 'rgb.png')),
                                  jio.read_image(str(tmp_path / 'rgb.png')))
