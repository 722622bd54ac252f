"""The port's dense CRF (ops/crf.py), `eval.amodal.infer_instseg` and
`eval.amodal.infer_amodal_hull` against the JAX package's on the CPU, on
the cases of tests/test_amodal.py and on the InstaOrder fixture scene of
tests/test_torch_amodal.py.

Bars:
  * densecrf (numpy / scipy on the host in both packages): equal on
    every value, one and two mean-field steps;
  * infer_instseg without and with the CRF (rgb given), on a seeded
    unet1d2 whose outc puts the fixture's eraser pixels on both sides of
    th (test_torch_amodal.moved_net), JAX's cubic RGB resize replaced by
    the port's (cv2's fixed-point INTER_CUBIC differs from the port's by
    1 LSB on <1% of values; tests/test_torch_train_data.py holds that
    resize): the same patches; the port's f64 forward of them within 1e-9
    of JAX's f64 forward (test_torch_legacy's F64_BAR, BatchNorm in f64
    on both sides), and the port's f32 probabilities within 1e-5 of
    JAX's, or twice JAX's own f32 distance from its f64 forward where
    that is larger (on these box prompts the moved outc's gain leaves
    JAX's f32 probabilities up to 7.2e-6 from its f64 run, and the
    port's 1.2e-5 from JAX's; f64: 1.2e-14); the masks equal wherever
    JAX's (CRF-refined) probability lies more than 1e-4 from th; and on
    test_amodal.py's random net, the shapes and dtypes;
  * infer_amodal_hull, grounded on an order matrix and not: equal on
    every value.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instaorder_tpu.eval import amodal as JAM
from instaorder_tpu.eval import heuristics as JH
from instaorder_tpu.models import unet as JU
from instaorder_tpu.ops import crf as JCRF

from instaorder_tpu_torch import convert
from instaorder_tpu_torch.core.nn import tree_cast
from instaorder_tpu_torch.eval import amodal as AM
from instaorder_tpu_torch.eval.tester import expand_bbox
from instaorder_tpu_torch.models import unet as TU
from instaorder_tpu_torch.ops import crf as TCRF
from instaorder_tpu_torch.ops.resize import resize_cubic_u8
from instaorder_tpu_torch.utils.geometry import crop_padding, mask_to_bbox

from test_torch_legacy import F64_BAR, bn_in_dtype, seeded, structure
from test_torch_amodal import (CS, PROB_BAR, SIZE, TH, completers,  # noqa
                               moved_net, one_torch_thread, scene)
import torch_threads  # noqa: F401 (the suite's torch thread cap)

NEAR = 1e-4


def edge_case():
    """tests/test_amodal.py's CRF case: a noisy unary on a two-region
    image."""
    h = w = 48
    rgb = np.zeros((h, w, 3), np.uint8)
    rgb[:, w // 2:] = [200, 40, 40]
    rng = np.random.RandomState(0)
    p1 = np.clip(0.5 + 0.15 * (np.arange(w) >= w // 2)[None, :]
                 + 0.25 * rng.randn(h, w), 0.02, 0.98)
    return np.stack([1 - p1, p1]), rgb


def test_densecrf_matches_jax():
    prob, rgb = edge_case()
    rng = np.random.RandomState(1)
    p = rng.dirichlet(np.ones(3), (40, 56)).transpose(2, 0, 1)
    img = rng.randint(0, 255, (40, 56, 3)).astype(np.uint8)
    for pr, im in ((prob, rgb), (p, img)):
        for iters in (1, 2):
            np.testing.assert_array_equal(TCRF.densecrf(pr, im, iters=iters),
                                          JCRF.densecrf(pr, im, iters=iters))
    refined = TCRF.densecrf(prob, rgb)
    gt = np.zeros((48, 48), bool)
    gt[:, 24:] = True
    assert ((refined[1] > 0.5) == gt).mean() > \
        ((prob[1] > 0.5) == gt).mean() + 0.05


def prob64(net, rec):
    """The class-1 probabilities of a recorded batch of patches through the
    port's UNet and JAX's in f64 (JAX under jax.enable_x64), BatchNorm in
    f64 on both sides (test_torch_legacy.bn_in_dtype)."""
    params, stats, cfg = net
    x = np.stack([rec['modal'], rec['eraser']], -1).astype(np.float64)
    with bn_in_dtype():
        with torch.no_grad():
            port = torch.softmax(TU.apply(
                *(tree_cast(convert.to_torch(t), torch.float64)
                  for t in (params, stats)), cfg, torch.from_numpy(x)),
                -1)[..., 1].numpy()
        with jax.enable_x64(True):
            jp, js = (jax.tree_util.tree_map(
                lambda a: jnp.asarray(np.asarray(a), jnp.float64), t)
                for t in (params, stats))
            want = np.asarray(jax.nn.softmax(JU.apply(
                jp, js, cfg, jnp.asarray(x))[0], -1)[..., 1])
    return port, want


@pytest.fixture
def port_cubic(monkeypatch):
    """cv2.INTER_CUBIC resizes (JAX's infer_instseg) through the port's
    resize_cubic_u8."""
    real = cv2.resize

    def resize(img, dsize, interpolation=None, **kw):
        if interpolation == cv2.INTER_CUBIC:
            return resize_cubic_u8(img, dsize[1], dsize[0])
        return real(img, dsize, interpolation=interpolation, **kw)
    monkeypatch.setattr(cv2, 'resize', resize)


@pytest.mark.parametrize('crf', [False, True])
def test_infer_instseg_matches_jax(scene, port_cubic, crf):
    image, modal, cat, _ = scene
    bboxes = np.array([mask_to_bbox(m) for m in modal])
    new_bboxes = expand_bbox(bboxes)
    net = moved_net('unet1d2', 11, scene)
    port, jax_c, glog, wlog = completers(*net)
    kw = dict(input_size=SIZE, th=TH, rgb=image if crf else None)
    got = AM.infer_instseg(port, image, cat, bboxes, new_bboxes, **kw)
    want = JAM.infer_instseg(jax_c, image, cat, bboxes, new_bboxes, **kw)
    assert len(got) == len(want) == len(modal)
    np.testing.assert_array_equal(glog[0]['modal'], wlog[0]['modal'])
    np.testing.assert_array_equal(glog[0]['eraser'], wlog[0]['eraser'])
    assert not wlog[0]['eraser'].any()
    g64, w64 = prob64(net, wlog[0])
    assert np.abs(g64 - w64).max() <= F64_BAR
    bar = max(PROB_BAR, 2 * np.abs(wlog[0]['prob'] - w64).max())
    assert np.abs(glog[0]['prob'] - wlog[0]['prob']).max() <= bar
    prob = wlog[0]['prob']
    if crf:
        prob = np.stack([JCRF.densecrf(
            np.stack([1.0 - p, p]),
            resize_cubic_u8(crop_padding(image, nb, (0, 0, 0)), SIZE,
                            SIZE))[1] for p, nb in zip(prob, new_bboxes)])
    for g, w, p in zip(got, want, prob):
        assert g.dtype == np.uint8 and g.shape == (SIZE, SIZE)
        near = np.abs(p - TH) <= NEAR
        assert (g == w)[~near].all()
    shares = np.mean([w.mean() for w in want])
    assert 0.0 < shares < 1.0, shares     # not a vacuous threshold


def test_infer_instseg_small_net_matches_jax(port_cubic):
    """tests/test_amodal.py's case: a UNet of its structure (w 0.5, depth
    2; seeded as test_torch_legacy.seeded) at 32^2, with and without the
    CRF."""
    p, s, cfg = structure(JU.init, in_channels=2, w=0.5, n_classes=2,
                          depth=2)
    rng = np.random.RandomState(2)
    p, s = seeded(p, rng), seeded(s, rng)
    port = AM.AmodalCompleter(TU.apply, cfg, convert.to_torch(p),
                              convert.to_torch(s), input_size=32,
                              device='cpu')
    jax_c = JAM.AmodalCompleter(JU.apply, cfg, p, s, input_size=32)
    glog, wlog = CS.record_completer(port, []), CS.record_completer(jax_c,
                                                                    [])
    image = np.zeros((48, 48, 3), np.uint8)
    rgb = np.zeros((48, 48, 3), np.uint8)
    rgb[:, 24:] = [180, 60, 60]
    bboxes = np.array([[4, 4, 16, 16], [20, 20, 20, 20]])
    new_bboxes = np.array([[0, 0, 24, 24], [16, 16, 28, 28]])
    for r in (rgb, None):
        args = (image, np.ones(2), bboxes, new_bboxes)
        got = AM.infer_instseg(port, *args, input_size=32, th=0.5, rgb=r)
        want = JAM.infer_instseg(jax_c, *args, input_size=32, th=0.5, rgb=r)
        assert [g.shape for g in got] == [w.shape for w in want]
        assert all(g.dtype == np.uint8 for g in got)
        assert np.abs(glog[-1]['prob'] - wlog[-1]['prob']).max() <= PROB_BAR


def test_infer_amodal_hull_matches_jax(scene):
    inmodal = np.zeros((2, 20, 20), np.uint8)
    inmodal[0, 2:10, 2:10] = 1
    inmodal[1, 8:16, 8:16] = 1
    order = np.zeros((2, 2), int)
    order[0, 1] = -1
    cases = [(inmodal, order)]
    _, modal, _, _ = scene
    cases.append((modal, JH.infer_order_hull(modal)))
    for m, o in cases:
        for grounded in (True, False):
            got = AM.infer_amodal_hull(m, None, o, order_grounded=grounded)
            want = JAM.infer_amodal_hull(m, None, o, order_grounded=grounded)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
                assert g.dtype == w.dtype
    extra = (got[0] == 1) & (modal[0] == 0)
    assert extra.any()      # the hull adds pixels
