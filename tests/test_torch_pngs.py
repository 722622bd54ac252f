"""The port's debug PNGs (eval/tester.py `save_pngs`, eval/disp.py
`eval_dense_depth(save_dir=)`, utils/visualize.py) against the JAX
package's on the CPU: the same files, and each file's decoded pixels
equal on every value.

  * utils/visualize: `get_mid_top_from_masks` and
    `put_instance_mask_and_ID` equal to JAX's on every value;
    `draw_graph` draws the same figure (its PNG's pixels);
  * the Tester with save_pngs=1 on JAX's InstaOrder fixture: the
    occlusion loop (order_method area: mask/, occ_order/), the depth loop
    (yaxis: depth_order/) and the disparity route (midas_pretrained:
    depth_order/ and disp/), both packages' make_disp_forward replaced by
    one disparity that both compute exactly (the first normalised
    channel rounded to 1/8, plus 4: its values do not depend on the ulp
    in which the two preps' normalisations differ);
  * eval_dense_depth(save_dir=) on the same disparities and depths:
    distribution/depth/, pred_disp/, gt_disp/, rgb/;
  * without matplotlib, save_pngs and save_dir raise an ImportError that
    names it (never a silent skip).
"""

import os
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from instaorder_tpu.data import synthetic as JS
from instaorder_tpu.eval import disp as JDISP
from instaorder_tpu.eval.tester import Tester as JTester
from instaorder_tpu.utils import visualize as JV

from instaorder_tpu_torch.eval import disp as TDISP
from instaorder_tpu_torch.eval.tester import Tester as TTester
from instaorder_tpu_torch.utils import visualize as TV
import torch_threads  # noqa: F401 (the suite's torch thread cap)


@pytest.fixture(scope='module')
def insta(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('pngs'))
    ann, _, img = JS.make_instaorder_fixture(root, n_images=2)
    return ann, img


def pixels(path):
    return np.asarray(Image.open(path).convert('RGBA'))


def same_tree(a, b):
    """Both directories hold the same PNG files, pixel for pixel."""
    files = lambda d: sorted(  # noqa: E731
        os.path.relpath(os.path.join(r, f), d)
        for r, _, fs in os.walk(d) for f in fs if f.endswith('.png'))
    fa, fb = files(a), files(b)
    assert fa == fb and fa, (fa, fb)
    for f in fa:
        np.testing.assert_array_equal(pixels(os.path.join(a, f)),
                                      pixels(os.path.join(b, f)), err_msg=f)
    return fa


def test_visualize_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    image = rng.randint(0, 255, (60, 80, 3)).astype(np.uint8)
    masks = np.zeros((3, 60, 80), np.uint8)
    masks[0, 5:30, 10:40] = 1
    masks[1, 20:50, 30:70] = 1
    tops = TV.get_mid_top_from_masks(masks)
    assert tops == JV.get_mid_top_from_masks(masks)
    for cats in (None, [4, 7, 9]):
        np.testing.assert_array_equal(
            TV.put_instance_mask_and_ID(image, masks, tops, categories=cats),
            JV.put_instance_mask_and_ID(image, masks, tops, categories=cats))
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    order = np.array([[0, 1, 2], [0, 0, 1], [2, 0, 0]])
    ovl = np.array([[0, 1, 0], [1, 0, 0], [0, 0, 0]])
    for who, mod in (('port', TV), ('jax', JV)):
        fig = plt.figure(figsize=(4, 4))
        mod.draw_graph(order, ovl, ax=fig.add_subplot(111))
        fig.savefig(tmp_path / f'{who}.png')
        plt.close(fig)
    np.testing.assert_array_equal(pixels(tmp_path / 'port.png'),
                                  pixels(tmp_path / 'jax.png'))


def png_args(insta, out_dir, algo, tv, method):
    ann, img = insta
    return types.SimpleNamespace(
        model={'algo': algo, 'backbone_arch': None},
        data={'dataset': 'InstaOrder', 'val_annot_file': ann,
              'val_image_root': img, 'input_size': 64,
              'trainval_dataset': tv, 'patch_or_image': 'resize',
              'enlarge_box': 3.0, 'use_category': False,
              'remove_occ_bidirec': 0, 'remove_depth_overlap': 0},
        trainer={}, out_dir=str(out_dir), order_method=method, pairs='all',
        zd=0, load_model=None, disp_select_method='', save_pngs=1)


class Quiet:
    def info(self, *a, **k):
        pass


def disparity(x):
    """(1, h, w, 3) normalised -> (1, h, w): the first channel rounded to
    1/8, plus 4, as numpy (both packages' forwards return it)."""
    return np.round(np.asarray(x, np.float32)[..., 0] * 8) / 8 + 4


@pytest.mark.parametrize('algo,tv,method,subdirs', [
    ('InstaOrderNet_o', 'SupOcclusionOrderDataset', 'area',
     ('mask', 'occ_order')),
    ('InstaOrderNet_d', 'SupDepthOrderDataset', 'yaxis',
     ('mask', 'depth_order')),
    ('midas_pretrained', 'SupDepthOrderDataset', '',
     ('mask', 'depth_order', 'disp'))])
def test_tester_pngs_match_jax(insta, tmp_path, monkeypatch, algo, tv,
                               method, subdirs):
    monkeypatch.setattr(JDISP, 'make_disp_forward',
                        lambda *a, **k: lambda x: jnp.asarray(disparity(x)))
    monkeypatch.setattr(TDISP, 'make_disp_forward',
                        lambda *a, **k: lambda x: torch.from_numpy(
                            disparity(x)))
    res = {}
    for who, cls, kw in (('jax', JTester, {}),
                         ('port', TTester, {'device': 'cpu'})):
        t = cls(png_args(insta, tmp_path / who, algo, tv, method),
                logger=Quiet(), **kw)
        res[who] = t.run()
    assert res['port'] == res['jax']
    files = same_tree(tmp_path / 'port', tmp_path / 'jax')
    assert sorted({f.split(os.sep)[0] for f in files}) == sorted(subdirs)
    assert len(files) == 2 * len(subdirs)


def test_dense_depth_pngs_match_jax(tmp_path):
    rng = np.random.RandomState(1)
    reader, depths = [], {}
    for i in range(2):
        image = rng.randn(3, 48, 64).astype(np.float32)
        gt = rng.uniform(0.5, 9.0, (48, 64)).astype(np.float32)
        gt[rng.rand(48, 64) < 0.2] = 0
        depths[f'd{i}.png'] = gt
        reader.append((image, f'img_{i}.jpg', f'd{i}.png'))
    forward = lambda x: disparity(x) + 0.1 * np.asarray(x)[..., 1]  # noqa
    out = {}
    for who, mod in (('jax', JDISP), ('port', TDISP)):
        out[who] = mod.eval_dense_depth(
            forward, reader, dataset='nyu', read_gt_depth=depths.get,
            log=lambda *a: None, save_dir=str(tmp_path / who))
    assert out['port'] == out['jax']
    files = same_tree(tmp_path / 'port', tmp_path / 'jax')
    assert len(files) == 8
    assert {f.split(os.sep)[0] for f in files} == {
        'distribution', 'pred_disp', 'gt_disp', 'rgb'}


def test_pngs_without_matplotlib_raise(insta, tmp_path, monkeypatch):
    for name in [m for m in sys.modules if m.split('.')[0] == 'matplotlib']:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, 'matplotlib', None)
    with pytest.raises(ImportError, match='matplotlib'):
        TTester(png_args(insta, tmp_path, 'InstaOrderNet_o',
                            'SupOcclusionOrderDataset', 'area'),
                logger=Quiet(), device='cpu')
    with pytest.raises(ImportError, match='matplotlib'):
        TDISP.eval_dense_depth(lambda x: disparity(x), [], dataset='nyu',
                               save_dir=str(tmp_path))
