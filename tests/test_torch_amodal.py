"""The port's PCNet-M evaluation (eval/amodal.py, the Tester's
PartialCompletionMask method, cli/test) against the JAX package's on the
CPU, and the host helpers against cv2.

The nets are seeded trees of JAX's UNet structure (test_torch_unet.py),
their outc moved by chip_smoke.centre_outc so that the completion
probabilities straddle the threshold on the eraser pixels (a random
UNet's are ~0.5 everywhere, above th = 0.1: every patch would complete
to all ones, and the votes would not depend on the net). Each
infer_order call is recorded (chip_smoke.record_completer: pair order,
patches, probabilities, matrix). Bars:
  * `resize_mask`, `recover_mask`, `patch_to_fullimage`, `get_neighbors`,
    `get_ancestors`, `utils.geometry.dilate_square` and the host nearest
    resize (`ops.resize.resize_nearest_np`, at every source size 1-699)
    equal to JAX's / cv2's on every value;
  * infer_order ('all' and 'nbor', with a dilated eraser once) and
    infer_amodal: the same patches on every value, the probabilities
    within 1e-5 of JAX's, the order matrices equal at every sure cell
    (chip_smoke.pcnet_sure: a pair whose two votes cannot cross with
    every eraser pixel within 1e-4 of th flipped), the amodal patches
    equal where no probability lies within 1e-4 of th; the chunked
    forward (PATCH_CHUNK patches a forward) equal to one forward of
    every patch;
  * a *res net's infer_order with JAX's cubic RGB resize replaced by the
    port's (cv2's fixed-point INTER_CUBIC differs from the port's f32
    one by 1 LSB on <1% of values; tests/test_torch_train_data.py holds
    that resize);
  * the Tester (`cli.test --device cpu` against JAX's Tester) on the
    three experiments/*/pcnet_m configs, on fixtures, with a checkpoint
    of the port's save_state: matrices equal at every sure cell, the
    metrics equal where no cell differs.
"""

import os
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
import yaml

from instaorder_tpu.eval import amodal as JAM
from instaorder_tpu.eval import tester as JT
from instaorder_tpu.models import unet as JU

from instaorder_tpu_torch import convert
from instaorder_tpu_torch.cli import test as cli_test
from instaorder_tpu_torch.core import checkpoint as CK
from instaorder_tpu_torch.data import readers as R
from instaorder_tpu_torch.data import synthetic
from instaorder_tpu_torch.data.image_io import read_rgb
from instaorder_tpu_torch.eval import amodal as AM
from instaorder_tpu_torch.eval import tester as TT
from instaorder_tpu_torch.models import unet as TU
from instaorder_tpu_torch.ops.resize import resize_cubic_u8, resize_nearest_np
from instaorder_tpu_torch.utils.geometry import dilate_square

from test_torch_train_step import one_torch_thread  # noqa: F401 (a fixture)
from test_torch_unet import seeded_net
import torch_threads  # noqa: F401 (the suite's torch thread cap)

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke as CS  # noqa: E402

SIZE = 48
TH = CS.PCNET_TH
PROB_BAR = 1e-5


@pytest.mark.parametrize('interp', ['nearest', 'linear'])
def test_resize_and_recover_match_jax(interp):
    rng = np.random.RandomState(0)
    for h, w, size in ((37, 53, 48), (90, 61, 32), (20, 20, 64), (7, 9, 5)):
        m = (rng.rand(h, w) > 0.6).astype(np.uint8)
        np.testing.assert_array_equal(AM.resize_mask(m, size, interp),
                                      JAM.resize_mask(m, size, interp))
        bbox = [int(rng.randint(-10, 10)), int(rng.randint(-10, 10)),
                int(rng.randint(20, 70)), 0]
        p = (rng.rand(size, size) > 0.5).astype(np.uint8)
        np.testing.assert_array_equal(
            AM.recover_mask(p, bbox, h, w, interp),
            JAM.recover_mask(p, bbox, h, w, interp))
        bbs = [bbox, [3, -4, 17, 0]]
        ps = [p, p[::-1].copy()]
        np.testing.assert_array_equal(
            AM.patch_to_fullimage(ps, bbs, h, w, interp),
            JAM.patch_to_fullimage(ps, bbs, h, w, interp))


def test_graph_walks_match_jax():
    rng = np.random.RandomState(1)
    for n in (1, 4, 7, 12):
        g = rng.choice([-1, 0, 0, 1], size=(n, n))    # cycles included
        np.fill_diagonal(g, 0)
        for i in range(n):
            np.testing.assert_array_equal(AM.get_ancestors(g, i),
                                          JAM.get_ancestors(g, i))
            np.testing.assert_array_equal(AM.get_neighbors(g, i),
                                          JAM.get_neighbors(g, i))


@pytest.mark.parametrize('dst', [36, 48, 64, 256])
def test_resize_nearest_np_matches_cv2(dst):
    """The host nearest resize (the masks of resize_mask and of the
    datasets) at every source size 1-699, rows and columns."""
    for src in range(1, 700):
        m = np.arange(src, dtype=np.uint16)[None].repeat(3, 0)
        np.testing.assert_array_equal(
            resize_nearest_np(m, 3, dst),
            cv2.resize(m, (dst, 3), interpolation=cv2.INTER_NEAREST))
        np.testing.assert_array_equal(
            resize_nearest_np(m.T.copy(), dst, 3),
            cv2.resize(m.T.copy(), (3, dst), interpolation=cv2.INTER_NEAREST))


@pytest.mark.parametrize('k', [1, 2, 3, 4, 5, 9])
def test_dilate_square_matches_cv2(k):
    rng = np.random.RandomState(k)
    for h, w in ((13, 17), (5, 3), (1, 9), (40, 40)):
        m = (rng.rand(h, w) > 0.85).astype(np.uint8)
        m[0, 0] = m[-1, -1] = 1                       # the borders
        np.testing.assert_array_equal(
            dilate_square(m, k),
            cv2.dilate(m, np.ones((k, k), np.uint8), iterations=1))


@pytest.fixture(scope='module')
def scene(tmp_path_factory):
    """The InstaOrder fixture's first image: (image, modal, category,
    expanded bboxes)."""
    root = str(tmp_path_factory.mktemp('amodal'))
    insta, _, img = synthetic.make_instaorder_fixture(root, n_images=1,
                                                      n_instances=5)
    modal, cat, bboxes, _, fn = R.InstaOrderReader(insta)\
        .get_image_instances(0, with_gt=False)[:5]
    return (read_rgb(os.path.join(img, fn)), modal.astype(np.uint8), cat,
            TT.expand_bbox(bboxes))


def moved_net(name, seed, scene, use_rgb=False):
    """A seeded net whose outc puts the scene's eraser pixels on both sides
    of TH (chip_smoke.centre_outc on the port's own forward)."""
    params, stats, cfg = seeded_net(name, seed)
    comp = AM.AmodalCompleter(TU.apply, cfg, convert.to_torch(params),
                              convert.to_torch(stats), use_rgb=use_rgb,
                              device='cpu')
    log = CS.record_completer(comp, [])
    image, modal, cat, bboxes = scene
    comp.infer_order(image, modal, cat, bboxes, input_size=SIZE)
    x = torch.from_numpy(np.stack([log[0]['modal'], log[0]['eraser']],
                                  -1).astype(np.float32))
    kw = {}
    if use_rgb:
        kw['rgb'] = torch.from_numpy(np.stack([resize_cubic_u8(
            AM.crop_padding(image, bboxes[t], (0, 0, 0)), SIZE, SIZE)
            for t, _ in log[0]['ind']]).astype(np.float32))
    with torch.no_grad():
        logits = TU.apply(convert.to_torch(params), convert.to_torch(stats),
                          cfg, x, **kw)
    params = CS.centre_outc(params, CS.outc_margins(logits,
                                                    log[0]['eraser']))
    return params, stats, cfg


def completers(params, stats, cfg, use_rgb=False):
    """(port, JAX) completers of one tree, each recorded; returns them and
    their logs."""
    port = AM.AmodalCompleter(TU.apply, cfg, convert.to_torch(params),
                              convert.to_torch(stats), use_rgb=use_rgb,
                              input_size=SIZE, device='cpu')
    jax_c = JAM.AmodalCompleter(JU.apply, cfg, params, stats,
                                use_rgb=use_rgb, input_size=SIZE)
    return port, jax_c, CS.record_completer(port, []), \
        CS.record_completer(jax_c, [])


def assert_orders_match(got, want, what):
    """Per infer_order record: the same pairs and patches, probabilities
    within PROB_BAR, the matrices equal at every sure cell (and every
    pair sure here)."""
    assert len(got) == len(want) > 0, what
    for g, w in zip(got, want):
        assert g['ind'] == w['ind'], what
        if not w['ind']:
            continue
        np.testing.assert_array_equal(g['modal'], w['modal'])
        np.testing.assert_array_equal(g['eraser'], w['eraser'])
        assert np.abs(g['prob'] - w['prob']).max() <= PROB_BAR, what
        sure, kinds = CS.pcnet_sure(w)
        assert kinds['unsure'] == 0, (what, kinds)
        assert kinds['exact'] + kinds['sure'] > 0, (what, kinds)
        a, b = np.asarray(g['order']), np.asarray(w['order'])
        assert (a == b)[sure].all(), what
    above, _ = CS.eraser_shares(want)
    assert 0.05 < above < 0.95, (what, above)   # not a vacuous vote


@pytest.mark.parametrize('pairs,dilate', [('all', 0), ('nbor', 0),
                                          ('all', 3)])
def test_infer_order_and_amodal_match_jax(scene, pairs, dilate, monkeypatch):
    image, modal, cat, bboxes = scene
    net = moved_net('unet1d2', 11, scene)
    port, jax_c, glog, wlog = completers(*net)
    kw = dict(pairs=pairs, th=TH, dilate_kernel=dilate, input_size=SIZE)
    got = port.infer_order(image, modal, cat, bboxes, **kw)
    want = jax_c.infer_order(image, modal, cat, bboxes, **kw)
    assert_orders_match(glog, wlog, f'infer_order {pairs} {dilate}')
    np.testing.assert_array_equal(got, glog[0]['order'])
    # chunked: PATCH_CHUNK patches a forward, equal to one forward
    monkeypatch.setattr(AM, 'PATCH_CHUNK', 3)
    clog = []
    CS.record_completer(port, clog)
    port.infer_order(image, modal, cat, bboxes, **kw)
    assert len(glog[0]['ind']) > 3
    np.testing.assert_array_equal(clog[0]['prob'], glog[0]['prob'])
    np.testing.assert_array_equal(clog[0]['order'], glog[0]['order'])
    # infer_amodal on JAX's order matrix: ancestors and neighbours
    for grounded in (True, False):
        akw = dict(th=TH, dilate_kernel=dilate, input_size=SIZE,
                   order_grounded=grounded)
        monkeypatch.setattr(AM, 'PATCH_CHUNK', 64)
        g = np.array(port.infer_amodal(image, modal, cat, bboxes, want,
                                       **akw))
        w = np.array(jax_c.infer_amodal(image, modal, cat, bboxes, want,
                                        **akw))
        monkeypatch.setattr(AM, 'PATCH_CHUNK', 2)
        c = np.array(port.infer_amodal(image, modal, cat, bboxes, want,
                                       **akw))
        np.testing.assert_array_equal(c, g)
        np.testing.assert_array_equal(glog[-1]['eraser'], wlog[-1]['eraser'])
        assert np.abs(glog[-1]['prob'] - wlog[-1]['prob']).max() <= PROB_BAR
        near = np.abs(wlog[-1]['prob'] - TH) <= 1e-4
        assert (g == w)[~near].all() and g.shape == w.shape


def test_infer_order_res_matches_jax(scene, monkeypatch):
    """unet025res: the RGB patch (un-normalised) reaches the encoder."""
    real = cv2.resize

    def resize(img, dsize, interpolation=None, **kw):
        if interpolation == cv2.INTER_CUBIC:
            return resize_cubic_u8(img, dsize[1], dsize[0])
        return real(img, dsize, interpolation=interpolation, **kw)
    monkeypatch.setattr(JAM, 'cv2', type('cv2', (), {
        'resize': staticmethod(resize), 'INTER_CUBIC': cv2.INTER_CUBIC,
        'INTER_LINEAR': cv2.INTER_LINEAR,
        'INTER_NEAREST': cv2.INTER_NEAREST, 'dilate': cv2.dilate}))
    image, modal, cat, bboxes = scene
    net = moved_net('unet025res', 12, scene, use_rgb=True)
    port, jax_c, glog, wlog = completers(*net, use_rgb=True)
    kw = dict(pairs='all', th=TH, input_size=SIZE)
    port.infer_order(image, modal, cat, bboxes, **kw)
    jax_c.infer_order(image, modal, cat, bboxes, **kw)
    assert_orders_match(glog, wlog, 'infer_order res')


# ---------------------------------------------------------------------------
# the Tester on the three pcnet_m configs
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def fixtures(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('pcnet_fixtures'))
    insta, _, img = synthetic.make_instaorder_fixture(root, n_images=2,
                                                      n_instances=4)
    return {'InstaOrder': (insta, img),
            'COCOA': synthetic.make_cocoa_fixture(root),
            'KINS': synthetic.make_kins_fixture(root)}


@pytest.fixture(scope='module')
def tester_net(scene):
    """unet1d2 (the configs' unet2 cut to depth 2, width 1), outc moved on
    the scene; (params, stats, cfg) numpy."""
    return moved_net('unet1d2', 13, scene)


@pytest.mark.parametrize('dataset', CS.PCNET_DATASETS)
def test_tester_matches_jax(dataset, fixtures, tester_net, tmp_path,
                            monkeypatch):
    params, stats, cfg = tester_net
    ck = CK.save_state(str(tmp_path / 'ck'), 5, params, stats)
    raw = yaml.safe_load(open(REPO / 'experiments' / dataset / 'pcnet_m' /
                              'config.yaml'))
    ann, img = fixtures[dataset]
    raw['model']['backbone_arch'] = 'unet1d2'
    raw['data'].update(val_annot_file=ann, val_image_root=img,
                       input_size=SIZE)
    raw['trainer']['tensorboard'] = False
    path = tmp_path / 'config.yaml'
    path.write_text(yaml.safe_dump(raw))

    # the port through its CLI, each Tester's completer recorded
    glog = []
    prepare = TT.Tester.prepare_model

    def prepare_model(self):
        prepare(self)
        CS.record_completer(self.completer, glog)
    monkeypatch.setattr(TT.Tester, 'prepare_model', prepare_model)
    got = cli_test.main(['--config', str(path), '--load_model', ck,
                         '--device', 'cpu'])

    # JAX's Tester on the same file; its net's init (overwritten by the
    # checkpoint) skipped
    from instaorder_tpu_torch.cli.config import load_config
    args = load_config(str(path))
    args.order_method, args.load_model, args.pairs, args.zd = '', ck, \
        'all', 0
    monkeypatch.setattr(JT, 'get_backbone', lambda name: {
        'init': lambda key, **kw: (params, stats, cfg), 'apply': JU.apply})
    jt = JT.Tester(args)
    wlog = []
    jprepare = jt.prepare_model

    def jprepare_model():
        jprepare()
        CS.record_completer(jt.completer, wlog)
    jt.prepare_model = jprepare_model
    want = jt.run()
    assert jt.curr_step == 5
    assert_orders_match(glog, wlog, f'tester {dataset}')
    assert got == want, (got, want)


def test_cli_needs_a_gpu_by_default(fixtures, tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a GPU is present')
    raw = yaml.safe_load(open(REPO / 'experiments' / 'COCOA' / 'pcnet_m' /
                              'config.yaml'))
    path = tmp_path / 'config.yaml'
    path.write_text(yaml.safe_dump(raw))
    with pytest.raises(RuntimeError, match='no GPU'):
        cli_test.main(['--config', str(path)])
