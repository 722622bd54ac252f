"""The port's Mapillary reader and the loader's grain mode against the JAX
package's on the CPU.

  * MapillaryReader on the port's Mapillary fixture (data/synthetic
    .make_mapillary_fixture: 16-bit instance maps, PNG data under the
    reader's .jpg names) and on JAX's own test case (a PIL-written map,
    tests/test_data_layer.py::test_mapillary_reader): every instance's
    (modal, bbox, category, file) and every image's instances equal to
    JAX's reader on every value; `image_io.read_gray` equal to PIL;
  * PartialCompDataset through `dataset: Mapillary` (the pcnet_m YAML's
    data keys): samples equal to JAX's on every value, train and val;
  * DataLoader(mode='grain') as rank 1 of 2: batches equal on every
    value to the rows of JAX's grain-mode global batches that rank holds
    and to the port's thread mode at the same rank (JAX's grain batches
    equal its thread batches and the port's thread batches at world size
    1); without the grain package the constructor raises an ImportError
    that names it (no fallback to threads).
"""

import json
import os
import sys

import numpy as np
import pytest
import yaml
from PIL import Image

from instaorder_tpu.data import datasets as JD
from instaorder_tpu.data import loader as JLD
from instaorder_tpu.data import readers as JR

from instaorder_tpu_torch.data import datasets as TD
from instaorder_tpu_torch.data import image_io
from instaorder_tpu_torch.data import loader as TLD
from instaorder_tpu_torch.data import readers as TR
from instaorder_tpu_torch.data import synthetic

from test_torch_train_data import assert_samples_match
from test_torch_unet import REPO
import torch_threads  # noqa: F401 (the suite's torch thread cap)


@pytest.fixture(scope='module')
def fixture(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('mapillary'))
    return synthetic.make_mapillary_fixture(root, n_images=3,
                                            n_instances=4, h=72, w=96)


def jax_case(root):
    """tests/test_data_layer.py::test_mapillary_reader's map, through
    PIL."""
    inst = np.zeros((40, 50), np.uint16)
    inst[5:20, 5:20] = 1 * 256 + 3
    inst[25:35, 30:45] = 2 * 256 + 7
    os.makedirs(f'{root}/instances', exist_ok=True)
    Image.fromarray(inst).save(f'{root}/instances/img0.png')
    annot = {'categories': [], 'images': [
        {'image_id': 'img0', 'regions': [
            {'instance_id': 1 * 256 + 3, 'category_id': 1},
            {'instance_id': 2 * 256 + 7, 'category_id': 2}]}]}
    with open(f'{root}/ann.json', 'w') as f:
        json.dump(annot, f)
    return f'{root}/ann.json', root, inst


def hold_readers(t, j):
    assert t.get_image_length() == j.get_image_length()
    assert t.get_instance_length() == j.get_instance_length()
    for i in range(j.get_instance_length()):
        g, w = t.get_instance(i), j.get_instance(i)
        for a, b in zip(g, w):
            if isinstance(b, np.ndarray):
                np.testing.assert_array_equal(a, b)
                assert a.dtype == b.dtype
            else:
                assert a == b
    for i in range(j.get_image_length()):
        g, w = t.get_image_instances(i), j.get_image_instances(i)
        for a, b in zip(g, w):
            if isinstance(b, np.ndarray):
                np.testing.assert_array_equal(a, b)
                assert a.dtype == b.dtype, (a.dtype, b.dtype)
            else:
                assert a == b


def test_mapillary_reader_matches_jax(fixture, tmp_path):
    ann, root, _ = fixture
    hold_readers(TR.MapillaryReader(root, ann), JR.MapillaryReader(root, ann))
    ann2, root2, inst = jax_case(str(tmp_path))
    t = TR.MapillaryReader(root2, ann2)
    hold_readers(t, JR.MapillaryReader(root2, ann2))
    np.testing.assert_array_equal(
        image_io.read_gray(f'{root2}/instances/img0.png'), inst)
    # the fixture's maps: 16-bit PNGs equal to PIL's decode
    for fn in sorted(os.listdir(f'{root}/instances')):
        got = image_io.read_gray(f'{root}/instances/{fn}')
        np.testing.assert_array_equal(
            got, np.array(Image.open(f'{root}/instances/{fn}')))
    with pytest.raises(ValueError):
        t.get_instance(0, with_gt=True)


def mapillary_data(fixture, **over):
    """experiments/InstaOrder/pcnet_m/config.yaml's data keys with
    dataset Mapillary on the fixture."""
    ann, root, img = fixture
    raw = yaml.safe_load(open(REPO / 'experiments' / 'InstaOrder' /
                              'pcnet_m' / 'config.yaml'))
    cfg = dict(raw['data'], dataset='Mapillary', input_size=48,
               train_annot_file=ann, val_annot_file=ann, train_root=root,
               val_root=root, train_image_root=img, val_image_root=img)
    cfg.update(over)
    return cfg


@pytest.mark.parametrize('phase,rgb', [('train', False), ('train', True),
                                       ('val', False)])
def test_mapillary_partial_comp_matches_jax(fixture, phase, rgb):
    cfg = mapillary_data(fixture, load_rgb=rgb)
    jds = JD.PartialCompDataset(cfg, phase)
    tds = TD.DATASETS['PartialCompDataset'](cfg, phase,
                                            'PartialCompletionMask')
    assert isinstance(tds.data_reader, TR.MapillaryReader)
    assert len(tds) == len(jds) > 0
    for i in range(5):
        idx = (5 * i) % len(jds)
        assert_samples_match(
            tds.sample(idx, np.random.RandomState(300 + i)),
            jds.sample(idx, np.random.RandomState(300 + i)),
            f'mapillary {phase} {idx}')


def same_batches(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for k in b:
            np.testing.assert_array_equal(np.asarray(a[k]),
                                          np.asarray(b[k]))


def test_grain_mode_matches_thread_and_jax(fixture):
    cfg = mapillary_data(fixture, load_rgb=True)
    jds = JD.PartialCompDataset(cfg, 'train')
    tds = TD.DATASETS['PartialCompDataset'](cfg, 'train',
                                            'PartialCompletionMask')
    order = [3, 0, 7, 5, 1, 2, 6, 4]
    kw = dict(num_workers=1, seed=7)
    # JAX's grain batches of 4 (each grain loader starts a worker process,
    # ~9 s here: two in all)
    glob = list(JLD.DataLoader(jds, order, batch_size=4, mode='grain', **kw))
    same_batches(glob, list(JLD.DataLoader(jds, order, batch_size=4,
                                           mode='thread', **kw)))
    # rank 1 of 2 in grain mode: its half of each of JAX's global batches,
    # and the port's thread mode at the same rank and at world size 1
    mine = order[2:4] + order[6:8]
    rank1 = list(TLD.DataLoader(tds, mine, batch_size=2, mode='grain',
                                rank=1, world_size=2, **kw))
    same_batches(rank1, [{k: v[2:] for k, v in b.items()} for b in glob])
    same_batches(rank1, list(TLD.DataLoader(
        tds, mine, batch_size=2, mode='thread', rank=1, world_size=2, **kw)))
    whole = list(TLD.DataLoader(tds, order, batch_size=4, mode='thread',
                                **kw))
    same_batches(whole, glob)


def test_grain_mode_without_grain_raises(fixture, monkeypatch):
    cfg = mapillary_data(fixture)
    tds = TD.DATASETS['PartialCompDataset'](cfg, 'train',
                                            'PartialCompletionMask')
    monkeypatch.setitem(sys.modules, 'grain', None)
    monkeypatch.setitem(sys.modules, 'grain.python', None)
    with pytest.raises(ImportError, match='grain'):
        TLD.DataLoader(tds, [0, 1], batch_size=2, mode='grain')
