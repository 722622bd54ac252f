"""The host modules of the port's Tester slice against the JAX package on
the CPU: the RLE codec (numpy and native C++), the PNG reader, the
synthetic fixtures and readers, metrics, heuristics, checkpoint I/O
(byte for byte with flax), the basic-block ResNets, the registry, the
config loader and CLI, and the rule that no port module needs PIL,
PyYAML, msgpack, cv2, matplotlib, networkx, tensorboardX or wandb at
import time.
"""

import glob
import json
import os
import shutil
import struct
import subprocess
import sys
import types
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from instaorder_tpu.cli import config as JCFG
from instaorder_tpu.core import checkpoint as JCK
from instaorder_tpu.data import readers as JR
from instaorder_tpu.data import rle as JRLE
from instaorder_tpu.data import synthetic as JS
from instaorder_tpu.eval import heuristics as JH
from instaorder_tpu.eval import metrics as JM
from instaorder_tpu.eval import tester as JT
from instaorder_tpu.models import registry as JREG
from instaorder_tpu.models import resnet as jresnet
from instaorder_tpu.utils import geometry as JG
from instaorder_tpu.utils import telemetry as JTEL

from instaorder_tpu_torch import convert, native
from instaorder_tpu_torch.cli import config as TCFG
from instaorder_tpu_torch.core import checkpoint as TCK
from instaorder_tpu_torch.data import image_io
from instaorder_tpu_torch.data import readers as TR
from instaorder_tpu_torch.data import rle as TRLE
from instaorder_tpu_torch.data import synthetic as TS
from instaorder_tpu_torch.eval import disp as TDISP
from instaorder_tpu_torch.eval import heuristics as TH
from instaorder_tpu_torch.eval import metrics as TM
from instaorder_tpu_torch.eval import pipeline as TPL
from instaorder_tpu_torch.eval import tester as TT
from instaorder_tpu_torch.models import midas as tmidas
from instaorder_tpu_torch.models import registry as TREG
from instaorder_tpu_torch.models import resnet as tresnet
from instaorder_tpu_torch.utils import geometry as TG
from instaorder_tpu_torch.utils import telemetry as TTEL

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke as CS  # noqa: E402

# what a machine without these packages lacks (rule (b) of the slice)
OPTIONAL = ('PIL', 'yaml', 'msgpack', 'cv2', 'matplotlib', 'networkx',
            'tensorboardX', 'wandb')


def blob(h, w, seed):
    from scipy.ndimage import gaussian_filter
    rng = np.random.RandomState(seed)
    return (gaussian_filter(rng.rand(h, w), 3) > 0.5).astype(np.uint8)


def rect_masks(n, h, w, seed):
    rng = np.random.RandomState(seed)
    m = np.zeros((n, h, w), np.uint8)
    for k in range(n):
        y0, x0 = rng.randint(0, h - 8), rng.randint(0, w - 8)
        m[k, y0:y0 + rng.randint(4, 16), x0:x0 + rng.randint(4, 16)] = 1
    return m


# ---------------------------------------------------------------------------
# RLE: numpy, native, JAX
# ---------------------------------------------------------------------------

@pytest.fixture(params=['numpy', 'native'])
def codec(request, monkeypatch):
    """The port's rle with its native hooks on ('native'; skipped only
    where no g++ is on PATH) or off ('numpy'); JAX's rle always numpy."""
    monkeypatch.setattr(JRLE, '_NATIVE', {})
    if request.param == 'numpy':
        monkeypatch.setattr(TRLE, '_NATIVE', {})
    else:
        if shutil.which('g++') is None:
            pytest.skip('no g++ to build the native codec')
        assert native.load() is not None, native.LOAD_ERROR
        assert native.registered()
    return request.param


def test_rle_encode_decode_matches_jax(codec):
    for seed, (h, w) in enumerate([(1, 1), (17, 23), (123, 217),
                                   (64, 1)]):
        m = blob(h, w, seed) if min(h, w) > 4 else (
            np.random.RandomState(seed).rand(h, w) > 0.5).astype(np.uint8)
        for mask in (m, np.zeros_like(m), np.ones_like(m)):
            r = TRLE.encode(mask)
            assert r == JRLE.encode(mask)
            np.testing.assert_array_equal(TRLE.decode(r), mask)
            np.testing.assert_array_equal(TRLE.decode(r), JRLE.decode(r))
            counts = TRLE.string_to_counts(r['counts'])
            np.testing.assert_array_equal(
                counts, JRLE.string_to_counts(r['counts']))
            assert TRLE.counts_to_string(counts) == r['counts']
            assert TRLE.area(r) == JRLE.area(r)
            assert TRLE.to_bbox(r) == JRLE.to_bbox(r)


def test_rle_polygon_merge_matches_jax(codec):
    rng = np.random.RandomState(3)
    for k in range(12):
        h, w = rng.randint(20, 90, size=2)
        pts = rng.uniform(-5, max(h, w) + 5, size=2 * rng.randint(3, 9))
        a = TRLE.from_polygon(pts, h, w)
        assert a == JRLE.from_polygon(pts, h, w)
        polys = [pts, rng.uniform(0, min(h, w), size=8)]
        objs = TRLE.fr_poly_objects(polys, h, w)
        assert objs == JRLE.fr_poly_objects(polys, h, w)
        for inter in (False, True):
            assert TRLE.merge(objs, intersect=inter) == JRLE.merge(
                objs, intersect=inter)
    r = JRLE.encode(blob(30, 40, 9))
    unc = {'size': r['size'],
           'counts': JRLE.string_to_counts(r['counts']).tolist()}
    assert TRLE.fr_poly_objects(unc, 30, 40) == JRLE.fr_poly_objects(
        unc, 30, 40)
    assert TRLE.merge([unc]) == JRLE.merge([unc])


def test_native_codec_loads_and_reports(tmp_path, monkeypatch):
    """load() builds into _build/ and registers its fast paths; when the
    build fails it returns None and LOAD_ERROR says why."""
    if shutil.which('g++') is None:
        pytest.skip('no g++ to build the native codec')
    lib = native.load()
    assert lib is not None and native.LOAD_ERROR is None
    assert native.registered()
    assert native._lib_path().parent == REPO / 'instaorder_tpu_torch' / \
        '_build'
    assert not (REPO / 'instaorder_tpu_torch' / 'native' /
                'librle_codec.so').exists()
    m = blob(50, 70, 1)
    np.testing.assert_array_equal(
        native.decode_counts(native.encode_mask(m), 50, 70), m)
    monkeypatch.setattr(native, '_lib', None)
    monkeypatch.setattr(native, 'BUILD_DIR', tmp_path)
    monkeypatch.setenv('CXX', 'false')
    assert native.load() is None
    assert 'failed' in native.LOAD_ERROR
    assert native.load(build_if_missing=False) is None
    assert 'not built' in native.LOAD_ERROR


# ---------------------------------------------------------------------------
# image_io
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('mode', ['L', 'RGB', 'RGBA', 'LA', 'P'])
def test_read_rgb_matches_pil(mode, tmp_path):
    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[0:37, 0:53]
    smooth = ((yy * 3 + xx * 5) % 256).astype(np.uint8)
    ch = {'L': 1, 'RGB': 3, 'RGBA': 4, 'LA': 2, 'P': 1}[mode]
    for k, base in enumerate((rng.randint(0, 256, (37, 53, ch)),
                              np.repeat(smooth[..., None], ch, 2))):
        arr = base.astype(np.uint8)
        if mode == 'P':
            im = Image.fromarray(arr[..., 0], 'L').convert('P')
        else:
            im = Image.fromarray(arr[..., 0] if ch == 1 else arr, mode)
        path = tmp_path / f'{k}.png'
        im.save(path)
        want = np.array(Image.open(path).convert('RGB'))
        got = image_io.read_rgb(path)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def _filter_rows(pix, bpp, kinds):
    """PNG-filter each row of (H, stride) uint8 with kinds[y % 5]."""
    h, stride = pix.shape
    out = []
    p = pix.astype(np.int32)
    for y in range(h):
        kind = kinds[y % len(kinds)]
        cur = p[y]
        up = p[y - 1] if y else np.zeros(stride, np.int32)
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])
        if kind == 0:
            f = cur
        elif kind == 1:
            f = cur - left
        elif kind == 2:
            f = cur - up
        elif kind == 3:
            f = cur - (left + up) // 2
        else:
            pa = np.abs(up - ul)
            pb = np.abs(left - ul)
            pc = np.abs(left + up - 2 * ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
            f = cur - pred
        out.append(np.concatenate([[kind], f & 0xFF]).astype(np.uint8))
    return np.stack(out).tobytes()


def _png(path, pix, ctype, w, h, raw):
    def chunk(kind, body):
        return (struct.pack('>I', len(body)) + kind + body +
                struct.pack('>I', zlib.crc32(kind + body) & 0xFFFFFFFF))
    with open(path, 'wb') as f:
        f.write(b'\x89PNG\r\n\x1a\n')
        f.write(chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, ctype, 0, 0,
                                           0)))
        f.write(chunk(b'IDAT', zlib.compress(raw)))
        f.write(chunk(b'IEND', b''))


@pytest.mark.parametrize('ctype,ch', [(0, 1), (2, 3), (6, 4)])
def test_read_rgb_every_row_filter(ctype, ch, tmp_path):
    """Rows hand-filtered with None, Sub, Up, Average and Paeth in turn
    (and each filter alone over a whole image) read back as PIL reads
    them."""
    rng = np.random.RandomState(ctype)
    h, w = 23, 31
    img = rng.randint(0, 256, (h, w, ch)).astype(np.uint8)
    img[5:12] = img[5:6]            # flat runs: predictors that hit
    for kinds in ([0, 1, 2, 3, 4], [1], [2], [3], [4]):
        path = tmp_path / f'f{"".join(map(str, kinds))}.png'
        _png(path, img, ctype, w, h,
             _filter_rows(img.reshape(h, w * ch), ch, kinds))
        got = image_io.read_rgb(path)
        np.testing.assert_array_equal(
            got, np.array(Image.open(path).convert('RGB')))
        np.testing.assert_array_equal(
            got, img[..., :3] if ch >= 3 else np.repeat(img, 3, 2))


def test_write_png_and_jpeg_through_pil(tmp_path):
    rng = np.random.RandomState(1)
    rgb = rng.randint(0, 256, (19, 27, 3)).astype(np.uint8)
    gray = rgb[..., 0]
    image_io.write_png(tmp_path / 'rgb.png', rgb)
    image_io.write_png(tmp_path / 'gray.png', gray)
    np.testing.assert_array_equal(np.array(Image.open(tmp_path / 'rgb.png')),
                                  rgb)
    np.testing.assert_array_equal(image_io.read_rgb(tmp_path / 'rgb.png'),
                                  rgb)
    np.testing.assert_array_equal(image_io.read_rgb(tmp_path / 'gray.png'),
                                  np.repeat(gray[..., None], 3, 2))
    Image.fromarray(rgb).save(tmp_path / 'x.jpg')
    np.testing.assert_array_equal(
        image_io.read_rgb(tmp_path / 'x.jpg'),
        np.array(Image.open(tmp_path / 'x.jpg').convert('RGB')))
    with pytest.raises(ValueError):
        image_io.write_png(tmp_path / 'bad.png', np.zeros((2, 2, 4)))


def test_read_rgb_without_pil(tmp_path):
    """With PIL blocked, PNG still reads and JPEG raises an ImportError
    that names the function and the package."""
    rgb = np.arange(2 * 3 * 3, dtype=np.uint8).reshape(2, 3, 3)
    image_io.write_png(tmp_path / 'a.png', rgb)
    Image.fromarray(rgb).save(tmp_path / 'a.jpg')
    code = ('import sys; sys.modules["PIL"] = None\n'
            'from instaorder_tpu_torch.data import image_io\n'
            f'a = image_io.read_rgb({str(tmp_path / "a.png")!r})\n'
            f'assert a.tolist() == {rgb.tolist()!r}\n'
            'try:\n'
            f'    image_io.read_rgb({str(tmp_path / "a.jpg")!r})\n'
            'except ImportError as e:\n'
            '    assert "read_rgb" in str(e) and "PIL" in str(e), e\n'
            'else:\n'
            '    raise SystemExit("no ImportError")\n')
    res = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]


# ---------------------------------------------------------------------------
# fixtures and readers
# ---------------------------------------------------------------------------

FIXTURES = {
    'instaorder': (JS.make_instaorder_fixture, TS.make_instaorder_fixture,
                   {'n_images': 3, 'n_instances': 5}),
    'cocoa': (JS.make_cocoa_fixture, TS.make_cocoa_fixture, {}),
    'kins': (JS.make_kins_fixture, TS.make_kins_fixture, {}),
}


def _images(ann_path, img_dir, kind):
    data = json.load(open(ann_path))
    if kind == 'instaorder':
        data = json.load(open(os.path.join(os.path.dirname(ann_path),
                                           'instances_val2017.json')))
    return [os.path.join(img_dir, im['file_name']) for im in data['images']]


@pytest.mark.parametrize('kind', list(FIXTURES))
def test_synthetic_fixture_matches_jax(kind, tmp_path):
    """Annotations field for field JAX's (the image names .png for .jpg);
    KINS images equal JAX's PNGs; InstaOrder / COCOA images, JPEG-encoded
    by PIL as JAX encodes its canvas, equal JAX's JPEGs."""
    jmake, tmake, kw = FIXTURES[kind]
    j = jmake(str(tmp_path / 'j'), **kw)
    t = tmake(str(tmp_path / 't'), **kw)
    n_json = 2 if kind == 'instaorder' else 1
    for a, b in zip(j[:n_json], t[:n_json]):
        want = json.dumps(json.load(open(a))).replace('.jpg"', '.png"')
        assert json.dumps(json.load(open(b))) == want
    jimgs, timgs = _images(j[0], j[-1], kind), _images(t[0], t[-1], kind)
    assert len(jimgs) == len(timgs) > 0
    for jp, tp in zip(jimgs, timgs):
        assert tp.endswith('.png')
        pix = image_io.read_rgb(tp)
        want = np.array(Image.open(jp).convert('RGB'))
        if jp.endswith('.png'):
            np.testing.assert_array_equal(pix, want)
        else:
            Image.fromarray(pix).save(tmp_path / 're.jpg')
            np.testing.assert_array_equal(
                np.array(Image.open(tmp_path / 're.jpg')), want)


def _assert_tree_equal(a, b):
    if isinstance(b, (list, tuple)) and not isinstance(b, np.ndarray):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tree_equal(x, y)
    elif isinstance(b, dict):
        assert a == b
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _instaorder_with_hard_orders(root):
    """The JAX InstaOrder fixture plus a bidirectional occlusion, an
    equal-depth pair and an overlapping depth record on image 0."""
    insta, inst, img = JS.make_instaorder_fixture(root, n_images=2,
                                                  n_instances=4)
    data = json.load(open(insta))
    ann = data['annotations'][0]
    ann['occlusion'].append({'order': '0<3 & 3<0'})
    ann['depth'] = [d for d in ann['depth']
                    if d['order'] not in ('1<2', '2<1', '3<1', '1<3')]
    ann['depth'] += [{'order': '1=2', 'overlap': True, 'count': 2},
                     {'order': '3<1', 'overlap': True, 'count': 1}]
    with open(insta, 'w') as f:
        json.dump(data, f)
    return insta, img


def test_readers_match_jax(tmp_path):
    insta, _ = _instaorder_with_hard_orders(str(tmp_path / 'i'))
    cocoa, _ = JS.make_cocoa_fixture(str(tmp_path / 'c'))
    kins, _ = JS.make_kins_fixture(str(tmp_path / 'k'))
    pairs = [(TR.InstaOrderReader(insta), JR.InstaOrderReader(insta)),
             (TR.COCOAReader(cocoa), JR.COCOAReader(cocoa)),
             (TR.KINSLVISReader('KINS', kins),
              JR.KINSLVISReader('KINS', kins))]
    for t, j in pairs:
        assert t.get_image_length() == j.get_image_length()
        assert t.get_instance_length() == j.get_instance_length()
        for i in range(j.get_image_length()):
            _assert_tree_equal(t.get_image_instances(i, with_gt=True),
                               j.get_image_instances(i, with_gt=True))
        for i in range(j.get_instance_length()):
            _assert_tree_equal(
                [x for x in t.get_instance(i, with_gt=True) if x is not None],
                [x for x in j.get_instance(i, with_gt=True) if x is not None])
    t, j = pairs[0]
    for i in range(j.get_image_length()):
        for bi in (0, 1):
            np.testing.assert_array_equal(
                t.get_gt_ordering(i, 'occlusion', rm_bidirec=bi),
                j.get_gt_ordering(i, 'occlusion', rm_bidirec=bi))
        for ov in (0, 1):
            _assert_tree_equal(t.get_gt_ordering(i, 'depth', rm_overlap=ov),
                               j.get_gt_ordering(i, 'depth', rm_overlap=ov))
    assert (t.get_gt_ordering(0, 'occlusion', rm_bidirec=1) == -1).any()
    assert (t.get_gt_ordering(0, 'depth')[0] == 2).any()
    t, j = pairs[1]
    for i in range(j.get_image_length()):
        np.testing.assert_array_equal(t.get_gt_ordering(i),
                                      j.get_gt_ordering(i))
    assert set(TR.READERS) == set(JR.READERS)


def test_read_annotations_match_jax():
    rng = np.random.RandomState(5)
    h, w = 40, 50
    m = blob(h, w, 2)
    r = JRLE.encode(m)
    ann = {'inmodal_seg': r, 'inmodal_bbox': [1, 2, 3, 4],
           'category_id': 3, 'segmentation': [[5.0, 5.0, 30.0, 6.0, 20.0,
                                                30.0]]}
    _assert_tree_equal(TR.read_KINS(ann), JR.read_KINS(ann))
    lvis = {'segmentation': ann['segmentation'], 'bbox': [1, 1, 2, 2],
            'category_id': 1}
    _assert_tree_equal(TR.read_LVIS(lvis, h, w), JR.read_LVIS(lvis, h, w))
    lvis['segmentation'] = r
    _assert_tree_equal(TR.read_LVIS(lvis, h, w), JR.read_LVIS(lvis, h, w))
    poly = list(rng.uniform(0, 40, 8))
    for reg in ({'segmentation': poly, 'visible_mask': r},
                {'segmentation': poly},
                {'segmentation': poly,
                 'visible_mask': JRLE.encode(np.zeros((h, w), np.uint8))}):
        _assert_tree_equal(TR.read_COCOA(reg, h, w),
                           JR.read_COCOA(reg, h, w))


# ---------------------------------------------------------------------------
# geometry, metrics, heuristics
# ---------------------------------------------------------------------------

def test_geometry_matches_jax():
    rng = np.random.RandomState(0)
    boxes = rng.randint(-5, 40, (6, 4)).astype(float)
    boxes[:, 2:] = np.abs(boxes[:, 2:]) + 1
    np.testing.assert_array_equal(TG.combine_bbox(boxes),
                                  JG.combine_bbox(boxes))
    m = blob(30, 40, 4)
    assert TG.mask_to_bbox(m) == JG.mask_to_bbox(m)
    assert TG.mask_to_bbox(m * 0) == JG.mask_to_bbox(m * 0)
    for a, b in zip(boxes, boxes[::-1]):
        a2 = (a[0], a[1], a[0] + a[2], a[1] + a[3])
        b2 = (b[0], b[1], b[0] + b[2], b[1] + b[3])
        assert TG.bbox_iou(a2, b2) == JG.bbox_iou(a2, b2)
        img = rng.randint(0, 255, (30, 40, 3)).astype(np.uint8)
        np.testing.assert_array_equal(
            TG.crop_padding(img, a, (1, 2, 3)),
            JG.crop_padding(img, a, (1, 2, 3)))
        assert TG.pair_crop_bbox(a, b) == JG.pair_crop_bbox(a, b)
        assert TG.pair_crop_bbox(
            a, b, (-0.1, 0.1), (0.8, 1.2), np.random.RandomState(1)) == \
            JG.pair_crop_bbox(a, b, (-0.1, 0.1), (0.8, 1.2),
                              np.random.RandomState(1))
    inst, eraser = blob(40, 40, 7), blob(40, 40, 8)
    cfg = {'min_overlap': 0.4, 'max_overlap': 1.0, 'min_cut_ratio': 0.001,
           'max_cut_ratio': 0.9}
    np.testing.assert_array_equal(
        TG.EraserSetter(cfg)(inst, eraser, np.random.RandomState(2)),
        JG.EraserSetter(cfg)(inst, eraser, np.random.RandomState(2)))
    for f in ('scissor_mask_force',):
        for x, y in zip(getattr(TG, f)(inst, eraser, 0.4, 1.0, 0.0, 1.0, 5,
                                       np.random.RandomState(3)),
                        getattr(JG, f)(inst, eraser, 0.4, 1.0, 0.0, 1.0, 5,
                                       np.random.RandomState(3))):
            np.testing.assert_array_equal(x, y)
    aug = {'flip': True, 'scale': [0.8, 1.2], 'shift': [-0.2, 0.2]}
    np.testing.assert_array_equal(
        TG.mask_aug(inst * 255, aug, np.random.RandomState(4)),
        JG.mask_aug(inst * 255, aug, np.random.RandomState(4)))
    for x, y in zip(TG.base_aug(inst, eraser, aug, np.random.RandomState(5)),
                    JG.base_aug(inst, eraser, aug, np.random.RandomState(5))):
        np.testing.assert_array_equal(x, y)
    assert TG.get_closest_int_multiple_of(47, 32) == \
        JG.get_closest_int_multiple_of(47, 32)


def _order_matrices(n, seed):
    rng = np.random.RandomState(seed)
    pred = rng.randint(0, 2, (n, n))
    gt = rng.randint(-1, 2, (n, n))
    return pred, gt


@pytest.mark.parametrize('zd', [0, 1])
def test_metrics_match_jax(zd):
    for seed in range(20):
        n = 2 + seed % 6
        pred, gt = _order_matrices(n, seed)
        if seed % 5 == 0:
            gt = np.zeros_like(gt)          # no positives: zero_division
        if seed % 7 == 0:
            pred = np.zeros_like(pred)
        assert TM.eval_order_recall_precision_f1(pred, gt, zd) == \
            JM.eval_order_recall_precision_f1(pred, gt, zd)
        for x, y in zip(TM.eval_order(pred, gt), JM.eval_order(pred, gt)):
            np.testing.assert_array_equal(x, y)
        rng = np.random.RandomState(seed)
        depth = rng.randint(-1, 3, (n, n))
        ovl = rng.randint(-1, 2, (n, n))
        count = rng.randint(1, 4, (n, n))
        if seed % 4 == 0:
            ovl[:] = 0                      # empty slices: the -1 sentinel
        order = rng.randint(0, 3, (n, n))
        got = TM.eval_depth_order_whdr(order, [depth, ovl, count])
        want = JM.eval_depth_order_whdr(order, [depth, ovl, count])
        assert dict(got) == dict(want)
        np.testing.assert_array_equal(TM.extract_upper_tri(depth),
                                      JM.extract_upper_tri(depth))
    rng = np.random.RandomState(1)
    gt_d, pr_d = rng.uniform(1, 80, 500), rng.uniform(1, 80, 500)
    assert TM.compute_errors(gt_d, pr_d) == JM.compute_errors(gt_d, pr_d)
    mask = rng.rand(500) > 0.3
    assert TM.compute_scale_and_shift(pr_d, gt_d, mask) == \
        JM.compute_scale_and_shift(pr_d, gt_d, mask)
    assert TM.compute_scale_and_shift(pr_d, gt_d, mask * 0) == (0.0, 0.0)
    disp = rng.rand(20, 30)
    for o in ('>', '<'):
        assert TM.diw_whdr_update(disp, [1, 2], [5, 6], o) == \
            JM.diw_whdr_update(disp, [1, 2], [5, 6], o)
    logits, tgt = rng.randn(40, 7), rng.randint(0, 7, 40)
    assert TM.accuracy_topk(logits, tgt, (1, 3, 5)) == \
        JM.accuracy_topk(logits, tgt, (1, 3, 5))


def test_heuristics_match_jax():
    for seed in range(4):
        m = rect_masks(3 + seed, 48, 64, seed)
        amodal = np.clip(m + rect_masks(3 + seed, 48, 64, seed + 50), 0, 1)
        for occluder in ('smaller', 'larger'):
            np.testing.assert_array_equal(
                TH.infer_occ_order_area(m, occluder, device='cpu'),
                JH.infer_occ_order_area(m, occluder))
            np.testing.assert_array_equal(
                TH.infer_depth_order_area(m, occluder),
                JH.infer_depth_order_area(m, occluder))
        for side in ('lower', 'higher'):
            np.testing.assert_array_equal(
                TH.infer_occ_order_yaxis(m, side, device='cpu'),
                JH.infer_occ_order_yaxis(m, side))
            np.testing.assert_array_equal(
                TH.infer_depth_order_yaxis(m, side),
                JH.infer_depth_order_yaxis(m, side))
        np.testing.assert_array_equal(TH.infer_order_hull(m),
                                      JH.infer_order_hull(m))
        np.testing.assert_array_equal(
            TH.infer_gt_order(m, amodal, device='cpu'),
            JH.infer_gt_order(m, amodal))
        np.testing.assert_array_equal(TH.convex_hull_image(m[0]),
                                      JH.convex_hull_image(m[0]))


def test_heuristics_need_a_device(monkeypatch):
    """device None means the card: without one the bordering test raises
    rather than running on the CPU."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        TH.infer_occ_order_area(rect_masks(3, 20, 20, 0))
    with pytest.raises(RuntimeError, match='CUDA'):
        TT.Tester(types.SimpleNamespace(model={'algo': 'x'}, data={}))


def test_expand_bbox_matches_jax():
    rng = np.random.RandomState(0)
    b = rng.uniform(0, 100, (9, 4))
    for e in (1.0, 3.0):
        np.testing.assert_array_equal(TT.expand_bbox(b, e),
                                      JT.expand_bbox(b, e))


# ---------------------------------------------------------------------------
# checkpoints: the port's codec against flax
# ---------------------------------------------------------------------------

def _tree(seed):
    rng = np.random.RandomState(seed)
    return {
        'params': {'conv1': {'w': rng.randn(3, 3, 5, 8).astype(np.float32)},
                   'layer1': [{'bn1': {'scale': np.ones(8, np.float32),
                                       'bias': np.zeros(8, np.float32)}},
                              {'w': rng.randn(4).astype(np.float16)}],
                   'fc': {'w': rng.randn(8, 2).astype(np.float32),
                          'b': np.zeros(2, np.float32)}},
        'stats': {'bn1': {'mean': rng.randn(8).astype(np.float32),
                          'var': np.ones(8, np.float32)}},
        'misc': {'ints': [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32,
                          -1, -32, -33, -129, -40000, -2 ** 40],
                 'floats': [0.5, -1e300], 'flags': [True, False, None],
                 'str': 'x' * 40, 'big': {f'k{i:02d}': np.int64(i)
                                          for i in range(20)},
                 'scalars': [np.float32(1.5), np.bool_(True), np.uint8(200),
                             np.array(3.0), np.zeros((0, 3), np.int32)],
                 'long': list(range(20))},
    }


def _equal(a, b):
    if isinstance(b, dict):
        assert isinstance(a, dict) and sorted(a) == sorted(b)
        for k in b:
            _equal(a[k], b[k])
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert type(a) is type(b) and a == b


def test_checkpoint_codec_bytes_equal_flax():
    from flax import serialization
    for seed in range(3):
        tree = _tree(seed)
        want = serialization.msgpack_serialize(tree)
        assert TCK.serialize(tree) == want
        _equal(TCK.restore(want), serialization.msgpack_restore(want))
    import msgpack
    for v in (0, 2 ** 63, -2 ** 63, 1.25, 'é' * 3, b'\x00' * 300, [],
              {'a': None}):
        assert TCK.packb(v) == msgpack.packb(v, use_bin_type=True)
        assert TCK.unpackb(msgpack.packb(v, use_bin_type=True)) == v


def test_checkpoint_chunked_leaves(monkeypatch):
    """Arrays over the chunk size are written and read in flax's
    chunked form (the size lowered on both sides to test it)."""
    from flax import serialization
    monkeypatch.setattr(serialization, 'MAX_CHUNK_SIZE', 64)
    monkeypatch.setattr(TCK, 'MAX_CHUNK_SIZE', 64)
    tree = {'a': {'b': np.arange(100, dtype=np.float32)},
            'l': [np.arange(50, dtype=np.int64)], 'c': np.ones(3)}
    want = serialization.msgpack_serialize(tree)
    assert TCK.serialize(tree) == want
    _equal(TCK.restore(want), serialization.msgpack_restore(want))
    assert '__msgpack_chunked_array__' in TCK.unpackb(want)['a']['b']


def test_checkpoint_files_cross_load(tmp_path):
    """save_state writes flax's bytes for the same tree (tensor leaves
    too), and each package loads the other's file."""
    tree = _tree(0)
    params, stats = tree['params'], tree['stats']
    j = JCK.save_state(str(tmp_path / 'j'), 17, params, stats)
    t = TCK.save_state(str(tmp_path / 't'), 17, params, stats)
    assert os.path.basename(j) == os.path.basename(t) == \
        'ckpt_iter_17.ckpt'
    assert open(j, 'rb').read() == open(t, 'rb').read()
    tt = TCK.save_state(str(tmp_path / 'tt'), 17,
                        convert.to_torch(params), convert.to_torch(stats))
    assert open(tt, 'rb').read() == open(j, 'rb').read()
    opt = {'mu': [np.ones(2, np.float32)], 'count': np.int32(3)}
    jo = JCK.save_state(str(tmp_path / 'jo'), 5, params, stats, opt)
    to = TCK.save_state(str(tmp_path / 'to'), 5, params, stats, opt)
    assert open(jo, 'rb').read() == open(to, 'rb').read()
    for path, load in ((j, TCK.load_state), (t, JCK.load_state),
                       (jo, TCK.load_state), (to, JCK.load_state)):
        step, p, s, o = load(path, params, stats, opt, warn=lambda m: None)
        assert step == int(path.split('_')[-1].split('.')[0])
        _equal(p, params)
        _equal(s, stats)
        if path in (jo, to):
            # saved as JAX saves: every leaf through np.asarray
            _equal(o, jax.tree_util.tree_map(np.asarray, opt))


def test_checkpoint_lenient_merge_warnings(tmp_path):
    tree = _tree(1)
    path = JCK.save_state(str(tmp_path), 3, tree['params'], tree['stats'])
    target = {
        'conv1': {'w': np.zeros((3, 3, 5, 8), np.float32),
                  'extra': np.zeros(2)},
        'layer1': [{'bn1': {'scale': np.zeros(8, np.float32)}}],
        'fc': {'w': np.zeros((8, 3), np.float32),
               'b': np.zeros(2, np.float32)},
        'head': {'w': np.zeros(1)}}
    stats = {'bn1': np.zeros(8)}
    out = {}
    for name, mod in (('jax', JCK), ('port', TCK)):
        warns = []
        out[name] = mod.load_state(path, target, stats, warn=warns.append)
        out[name + ' warnings'] = warns
    assert out['port warnings'] == out['jax warnings']
    assert len(out['jax warnings']) >= 4
    _equal(out['port'][1], out['jax'][1])
    _equal(out['port'][2], out['jax'][2])
    assert TCK.parse_iter(path) == JCK.parse_iter(path) == 3
    assert TCK.latest_checkpoint(str(tmp_path)) == \
        JCK.latest_checkpoint(str(tmp_path))
    assert TCK.latest_checkpoint(str(tmp_path / 'none')) is None
    with pytest.raises(FileNotFoundError):
        TCK.load_state(str(tmp_path / 'missing.ckpt'), target, stats)


# ---------------------------------------------------------------------------
# models: basic-block resnets, registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('arch,layers', [('resnet18', (1, 1, 1, 1)),
                                         ('resnet34', (2, 1, 1, 1))])
def test_basic_resnet_matches_jax(arch, layers):
    params, stats, cfg = jresnet.init(
        jax.random.PRNGKey(0), arch=arch, in_channels=5, num_classes=[2, 3],
        weight_init='kaiming_out', layers_override=layers)
    rng = np.random.RandomState(0)
    stats = jax.tree_util.tree_map(
        lambda v: np.asarray(v) + rng.uniform(0.1, 0.5, np.shape(v)).astype(
            np.float32), stats)
    x = rng.randn(3, 64, 96, 5).astype(np.float32)
    jp = convert.to_torch(jax.device_get(params))
    js = convert.to_torch(stats)
    _, _, tcfg = tresnet.init(torch.Generator().manual_seed(0), arch=arch,
                              in_channels=5, num_classes=[2, 3],
                              layers_override=layers)
    assert tcfg == {**cfg, 'layers': tuple(layers)}
    for valid in (None, (64, 64)):
        xv = x if valid is None else np.where(
            np.arange(96)[None, None, :, None] < 64, x, 0).astype(np.float32)
        want, _ = jresnet.apply(params, stats, cfg, jnp.asarray(xv),
                                valid_hw=valid)
        got = tresnet.apply(jp, js, tcfg, torch.from_numpy(xv),
                            valid_hw=valid)
        for g, w in zip(got, want):
            w = np.asarray(w)
            assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()
    tp, ts, _ = tresnet.init(torch.Generator().manual_seed(0), arch=arch,
                             in_channels=5, num_classes=2,
                             layers_override=(2, 1, 1, 1))
    jp2, js2, _ = jresnet.init(jax.random.PRNGKey(0), arch=arch,
                               in_channels=5, num_classes=2,
                               layers_override=(2, 1, 1, 1))
    shapes = lambda t: jax.tree_util.tree_map(lambda v: tuple(v.shape), t)
    assert shapes(convert.to_numpy(tp)) == shapes(jp2)
    assert shapes(convert.to_numpy(ts)) == shapes(js2)


def test_registry_matches_jax():
    assert sorted(TREG.BACKBONES) == sorted(JREG.BACKBONES)
    for name in TREG.UNET_NAMES:
        with pytest.raises(NotImplementedError, match='queue 1 item 4'):
            TREG.get_backbone(name)
    # the MiDaS family resolves (tests/test_torch_midas.py holds its trees)
    for name in TREG.MIDAS_NAMES:
        assert TREG.get_backbone(name)['apply'] is tmidas.apply
    with pytest.raises(KeyError):
        TREG.get_backbone('resnet9000')
    for name in ('resnet18_cls', 'resnet50_cls'):
        bb = TREG.get_backbone(name)
        p, s, cfg = bb['init'](torch.Generator().manual_seed(0),
                               in_channels=5, num_classes=2, device='cpu',
                               layers_override=(1, 1, 1, 1))
        jp, js, jcfg = JREG.get_backbone(name)['init'](
            jax.random.PRNGKey(0), in_channels=5, num_classes=2,
            layers_override=(1, 1, 1, 1))
        assert cfg == jcfg
        shapes = lambda t: jax.tree_util.tree_map(lambda v: tuple(v.shape), t)
        assert shapes(convert.to_numpy(p)) == shapes(jp)
        assert bb['apply'] is tresnet.apply


# ---------------------------------------------------------------------------
# config, CLI, telemetry
# ---------------------------------------------------------------------------

CONFIGS = sorted(glob.glob(str(REPO / 'experiments' / '*' / '*' /
                               'config.yaml')))


@pytest.mark.parametrize('path', CONFIGS,
                         ids=[os.path.relpath(p, REPO / 'experiments')
                              for p in CONFIGS])
def test_load_config_matches_jax(path):
    t, j = TCFG.load_config(path), JCFG.load_config(path)
    assert vars(t) == vars(j)
    assert TCFG.rewrite_paths({'a': '/data/x', 'b': 1}, '/r') == \
        JCFG.rewrite_paths({'a': '/data/x', 'b': 1}, '/r')


def test_chip_smoke_tester_configs_match_yaml():
    """chip_smoke.TESTER_CONFIGS (written out, as PyYAML may be missing on
    the card's machine) hold the experiment YAMLs' values, and every key
    the Tester reads that a YAML sets."""
    reads = {'model': ('algo', 'backbone_arch', 'backbone_param', 'use_rgb'),
             'data': ('dataset', 'trainval_dataset', 'input_size',
                      'patch_or_image', 'enlarge_box', 'use_category',
                      'remove_occ_bidirec', 'remove_depth_overlap'),
             'trainer': ('tensorboard', 'wandb')}
    assert len([k for k in CS.TESTER_CONFIGS
                if k.startswith('InstaOrder/')]) == 5
    for name, cfg in CS.TESTER_CONFIGS.items():
        ref = JCFG.load_config(str(REPO / 'experiments' / name /
                                   'config.yaml'))
        for section, keys in reads.items():
            want = getattr(ref, section)
            assert cfg[section] == {k: want[k] for k in keys if k in want}
    for _, cname, method, pairs in CS.TESTER_RUNS:
        assert cname in CS.TESTER_CONFIGS and pairs in ('all', 'nbor')
        assert method in ('', *TT.H_METHODS)


def test_cli_test_matches_jax(tmp_path, monkeypatch, capsys):
    """`python -m instaorder_tpu_torch.cli.test --device cpu` on a YAML
    config gives JAX's cli.test result on the same checkpoint."""
    import yaml
    from instaorder_tpu.cli import test as jcli
    from instaorder_tpu_torch.cli import test as tcli
    insta, _, img = JS.make_instaorder_fixture(str(tmp_path / 'f'),
                                               n_images=2, n_instances=3)
    raw = yaml.safe_load(open(REPO / 'experiments' / 'InstaOrder' /
                              'InstaOrderNet_o' / 'config.yaml'))
    raw['data'].update(base_dir='', val_annot_file=insta,
                       val_image_root=img, input_size=64)
    raw['model']['backbone_param']['layers_override'] = [1, 1, 1, 1]
    raw['trainer']['tensorboard'] = False
    cfg_path = tmp_path / 'config.yaml'
    cfg_path.write_text(yaml.safe_dump(raw))
    params, stats, _ = JREG.get_backbone('resnet50_cls')['init'](
        jax.random.PRNGKey(3), in_channels=5, num_classes=2,
        weight_init='kaiming_out', layers_override=(1, 1, 1, 1))
    ck = JCK.save_state(str(tmp_path / 'ck'), 9, params, stats)
    argv = ['--config', str(cfg_path), '--load_model', ck, '--pairs',
            'nbor', '--zd', '1', '--test_num', '2']
    monkeypatch.setattr(sys, 'argv', ['test'] + argv)
    jcli.main()
    want = capsys.readouterr().out.strip().splitlines()[-1]
    got = tcli.main(argv + ['--device', 'cpu'])
    assert capsys.readouterr().out.strip().splitlines()[-1] == str(got)
    assert str(got) == want
    with pytest.raises(NotImplementedError, match='queue 1 item 4'):
        tcli.main(argv + ['--device', 'cpu', '--save_pngs', '1'])
    # --disp_select_method runs the disparity route (an InstaDepthNet_d
    # YAML; a trimmed net in place of the full-width one)
    monkeypatch.setattr(TDISP, 'make_disp_forward', tiny_disp_forward)
    raw = yaml.safe_load(open(REPO / 'experiments' / 'InstaOrder' /
                              'InstaDepthNet_d' / 'config.yaml'))
    raw['data'].update(base_dir='', val_annot_file=insta,
                       val_image_root=img, input_size=64)
    raw['trainer']['tensorboard'] = False
    cfg_path.write_text(yaml.safe_dump(raw))
    for method in ('median', 'mean'):
        got = tcli.main(['--config', str(cfg_path), '--test_num', '2',
                         '--disp_select_method', method, '--device', 'cpu'])
        assert sorted(got) == sorted(f'WHDR_{o}_{e}' for o in (
            'ovlX', 'ovlO', 'ovlOX') for e in ('all', 'eq', 'neq'))


def tiny_disp_forward(algo, load_model=None, features=256, device=None):
    """eval/disp.make_disp_forward on a trimmed net (features 8, one block
    a stage; out_conv3's bias 0.5, so the disparity is positive)."""
    p, s, cfg = tmidas.init(torch.Generator().manual_seed(0), features=8,
                            variant=TDISP.ALGO_VARIANTS[algo],
                            trunk_layers=(1, 1, 1, 1),
                            branch_layers=(1, 1, 1, 1))
    p['out_conv3']['b'] += 0.5

    def forward(x):
        x = torch.as_tensor(x, dtype=torch.float32)
        with torch.no_grad():
            return tmidas.apply_disp(p, s, cfg, x)
    return forward


def test_tester_unported_routes_raise(tmp_path, monkeypatch):
    insta, _, img = JS.make_instaorder_fixture(str(tmp_path), n_images=1,
                                               n_instances=2)

    def args(**kw):
        a = types.SimpleNamespace(
            model={'algo': 'InstaOrderNet_o',
                   'backbone_arch': 'resnet50_cls',
                   'backbone_param': {'in_channels': 5, 'num_classes': 2}},
            data={'dataset': 'InstaOrder', 'val_annot_file': insta,
                  'val_image_root': img, 'patch_or_image': 'patch',
                  'input_size': 64,
                  'trainval_dataset': 'SupOcclusionOrderDataset'},
            trainer={}, out_dir=str(tmp_path))
        for k, v in kw.items():
            setattr(a, k, v)
        return a
    with pytest.raises(NotImplementedError, match='queue 1 item 4'):
        TT.Tester(args(save_pngs=1), device='cpu')
    with pytest.raises(NotImplementedError, match='queue 1 item 4'):
        TT.Tester(args(order_method='PartialCompletionMask'),
                  device='cpu').run()
    # the disparity route now runs: midas_pretrained, and InstaDepthNet_d
    # with disp_select_method (a trimmed net; a depth-order config)
    monkeypatch.setattr(TDISP, 'make_disp_forward', tiny_disp_forward)
    for algo, kw in (('midas_pretrained', {}),
                     ('InstaDepthNet_d', {'disp_select_method': 'median'})):
        a = args(**kw)
        a.model = dict(a.model, algo=algo, backbone_arch=None)
        a.data = dict(a.data, trainval_dataset='SupDepthOrderDataset')
        t = TT.Tester(a, device='cpu')
        out = t.run()
        assert isinstance(t.predictor, TPL.DisparityOrderPredictor)
        assert all(k.startswith('WHDR_') for k in out) and len(out) == 9


def test_telemetry_matches_jax(tmp_path):
    for mod, name in ((JTEL, 'j'), (TTEL, 't')):
        s = mod.make_summary_logger({'wandb': True}, str(tmp_path / name),
                                    run_name='Test', config={'a': 1})
        assert s.active
        s.scalars({'val/recall': 1.5, 'val/n': 3}, 7)
        s.scalar('val_ovlX/WHDR_all', np.float64(2.25), 8)
        s.flush()
        s.close()
        assert not mod.make_summary_logger({}, str(tmp_path)).active
    hist = {}
    for name in 'jt':
        (p,) = glob.glob(str(tmp_path / name / 'wandb' / 'run-*-Test' /
                             'history.jsonl'))
        hist[name] = [{k: v for k, v in json.loads(line).items()
                       if k != '_timestamp'} for line in open(p)]
    assert hist['t'] == hist['j'] and len(hist['j']) == 3


def test_tensorboard_true_needs_tensorboardx():
    """`tensorboard: true` (the experiment YAMLs) raises without
    tensorboardX, as the JAX package does."""
    code = ('import sys; sys.modules["tensorboardX"] = None\n'
            'from instaorder_tpu_torch.utils import telemetry\n'
            'try:\n'
            '    telemetry.make_summary_logger({"tensorboard": True}, ".")\n'
            'except RuntimeError as e:\n'
            '    assert "tensorboard" in str(e)\n'
            'else:\n'
            '    raise SystemExit("no RuntimeError")\n')
    res = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]


def test_port_imports_without_optional_packages():
    """Every port module and chip_smoke.py import with PIL, PyYAML,
    msgpack, cv2, matplotlib, networkx, tensorboardX and wandb blocked
    (and JAX), as on a machine that lacks them."""
    pkg = REPO / 'instaorder_tpu_torch'
    mods = sorted('instaorder_tpu_torch.' + '.'.join(
        p.relative_to(pkg).with_suffix('').parts)
        for p in pkg.rglob('*.py'))
    mods = [m[:-len('.__init__')] if m.endswith('.__init__') else m
            for m in mods]
    for m in ('eval.tester', 'data.readers', 'data.rle', 'data.image_io',
              'data.synthetic', 'core.checkpoint', 'models.registry',
              'cli.config', 'cli.test', 'utils.telemetry', 'native'):
        assert 'instaorder_tpu_torch.' + m in mods, m
    blocked = OPTIONAL + ('jax', 'flax', 'instaorder_tpu')
    code = ('import sys\n'
            f'for name in {blocked!r}: sys.modules[name] = None\n'
            'import importlib\n'
            f'for m in {mods!r}: importlib.import_module(m)\n'
            'import chip_smoke\n'
            f'bad = [m for m in sys.modules if m.split(".")[0] in '
            f'{blocked!r} and sys.modules[m] is not None]\n'
            'assert not bad, bad\n')
    res = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
