"""The port's training datasets, loader and host resizes against the JAX
package's on the CPU.

Both packages' datasets read the same fixture (the port's
data/synthetic.py: PNG images, which PIL reads for JAX) and draw each
sample with the same (idx, RandomState(seed)). Bars: every label and
mask value equal; the RGB before normalisation (recovered to uint8)
within 1 LSB on under 1% of its values (the ROADMAP's prep bar; cv2's
resizes are fixed-point, the port's cubic resize is f32). The loader:
the same batches for every worker count, in the thread and process
modes, and as JAX's loader; a worker's error reaches the consumer.
"""

import cv2
import numpy as np
import pytest

from instaorder_tpu.data import datasets as JD
from instaorder_tpu.data import loader as JLD
from instaorder_tpu.data.sampler import DistributedGivenIterationSampler

from instaorder_tpu_torch.data import datasets as TD
from instaorder_tpu_torch.data import loader as TLD
from instaorder_tpu_torch.data import synthetic
from instaorder_tpu_torch.ops import resize as TR

from test_torch_train_step import one_torch_thread  # noqa: F401 (a fixture)

SIZE = 64
SAMPLES = 6


@pytest.fixture(scope='module')
def fixture(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('train_data'))
    insta, _, img = synthetic.make_instaorder_fixture(
        root, n_images=4, n_instances=5, h=90, w=140, seed=3)
    return insta, img


def config(fixture, mode, **kw):
    insta, img = fixture
    cfg = {'dataset': 'InstaOrder', 'input_size': SIZE,
           'patch_or_image': mode, 'enlarge_box': 3.0, 'load_rgb': True,
           'use_category': False, 'remove_occ_bidirec': 0,
           'remove_depth_overlap': 0, 'extend_bidirec': 1,
           'base_aug': {'flip': True, 'shift': [-0.2, 0.2],
                        'scale': [0.8, 1.2]},
           'train_annot_file': insta, 'train_image_root': img,
           'val_annot_file': insta, 'val_image_root': img}
    cfg.update(kw)
    return cfg


def to_u8(rgb):
    return np.rint((rgb * TD.IMAGENET_STD + TD.IMAGENET_MEAN) * 255.0)


def assert_samples_match(got, want, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape, (what, k, g.shape, w.shape)
        if k == 'rgb':
            d = np.abs(to_u8(g) - to_u8(w))
            assert d.max() <= 1, (what, d.max())
            assert (d > 0).mean() < 0.01, (what, (d > 0).mean())
        else:
            np.testing.assert_array_equal(g, w, err_msg=f'{what} {k}')


DATASETS = [('SupOcclusionOrderDataset', 'InstaOrderNet_o'),
            ('SupOcclusionOrderDataset', 'OrderNet'),
            ('SupDepthOrderDataset', 'InstaOrderNet_d'),
            ('SupDepthOccOrderDataset', 'InstaOrderNet_od')]


@pytest.mark.parametrize('phase', ['train', 'val'])
@pytest.mark.parametrize('mode', ['patch', 'image', 'resize'])
@pytest.mark.parametrize('name,algo', DATASETS,
                         ids=[f'{n}-{a}' for n, a in DATASETS])
def test_datasets_match_jax(fixture, name, algo, mode, phase):
    cfg = config(fixture, mode)
    jds = JD.DATASETS[name](cfg, phase, algo)
    tds = TD.DATASETS[name](cfg, phase, algo)
    assert len(tds) == len(jds)
    for i in range(SAMPLES):
        idx = i % len(jds)
        want = jds.sample(idx, np.random.RandomState(100 + i))
        got = tds.sample(idx, np.random.RandomState(100 + i))
        assert_samples_match(got, want, f'{name} {mode} {phase} {idx}')


def test_partial_comp_dataset_refused(fixture):
    with pytest.raises(NotImplementedError, match='queue 1 item 4'):
        TD.DATASETS['PartialCompDataset'](config(fixture, 'patch'), 'train')
    assert sorted(TD.DATASETS) == sorted(JD.DATASETS)


@pytest.mark.parametrize('h,w,out', [(90, 140, 64), (140, 140, 64),
                                     (480, 640, 384), (57, 91, 256)])
def test_host_resizes_match_cv2(h, w, out):
    rng = np.random.RandomState(h + w)
    img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    mask = (rng.rand(h, w) > 0.5).astype(np.uint8)
    np.testing.assert_array_equal(
        TR.resize_nearest_np(mask, out, out),
        cv2.resize(mask, (out, out), interpolation=cv2.INTER_NEAREST))
    for got, flag in ((TR.resize_linear_u8(img, out, out), cv2.INTER_LINEAR),
                      (TR.resize_cubic_u8(img, out, out), cv2.INTER_CUBIC)):
        want = cv2.resize(img, (out, out), interpolation=flag)
        d = np.abs(got.astype(int) - want.astype(int))
        assert d.max() <= 1 and (d > 0).mean() < 0.01, (flag, d.max(),
                                                        (d > 0).mean())


def batches(loader):
    return [{k: v.copy() for k, v in b.items()} for b in loader]


def assert_batches_equal(a, b):
    assert len(a) == len(b) and len(a) > 0
    for x, y in zip(a, b):
        assert sorted(x) == sorted(y)
        for k in x:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


def test_loader_deterministic(fixture):
    cfg = config(fixture, 'patch')
    ds = TD.SupOcclusionOrderDataset(cfg, 'train', 'InstaOrderNet_o')
    sampler = DistributedGivenIterationSampler(len(ds), 3, 4, 1, 0)
    runs = [batches(TLD.DataLoader(ds, sampler, 4, num_workers=n, seed=5))
            for n in (1, 3)]
    runs.append(batches(TLD.DataLoader(ds, sampler, 4, num_workers=2,
                                       seed=5, mode='process')))
    for r in runs[1:]:
        assert_batches_equal(r, runs[0])
    # JAX's loader over its own dataset draws the same labels and masks
    jds = JD.SupOcclusionOrderDataset(cfg, 'train', 'InstaOrderNet_o')
    jb = batches(JLD.DataLoader(jds, sampler, 4, num_workers=2, seed=5))
    assert len(jb) == len(runs[0]) == 3
    for x, y in zip(runs[0], jb):
        for k in ('modal1', 'modal2', 'occ_order'):
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)
    assert len(TLD.DataLoader(ds, sampler, 4)) == 3


class _Failing:
    def __init__(self, bad):
        self.bad = bad

    def __len__(self):
        return 8

    def sample(self, idx, rng):
        if idx == self.bad:
            raise ValueError(f'sample {idx} is broken')
        return {'x': np.full((2,), idx, np.float32)}


def test_loader_worker_error_reaches_consumer(fixture, tmp_path):
    loader = TLD.DataLoader(_Failing(5), list(range(8)), 2, num_workers=2)
    got = []
    with pytest.raises(ValueError, match='sample 5 is broken'):
        for b in loader:
            got.append(b['x'][:, 0].tolist())
    assert got == [[0, 1], [2, 3]]
    # process mode: a worker process cannot read its image
    ds = TD.SupOcclusionOrderDataset(
        config(fixture, 'patch', train_image_root=str(tmp_path)), 'train',
        'InstaOrderNet_o')
    loader = TLD.DataLoader(ds, [0, 1], 2, num_workers=2, mode='process')
    with pytest.raises(FileNotFoundError):
        next(iter(loader))


def test_loader_modes():
    with pytest.raises(NotImplementedError, match='grain'):
        TLD.DataLoader(_Failing(-1), [0], 1, mode='grain')
    with pytest.raises(ValueError):
        TLD.DataLoader(_Failing(-1), [0], 1, mode='fork')
    # an early stop ends the producer and the pool
    loader = TLD.DataLoader(_Failing(-1), list(range(8)), 1, num_workers=2,
                            prefetch=1)
    for b in loader:
        break
    it = iter(loader)
    assert next(it)['x'][0, 0] == 0
    it.close()
