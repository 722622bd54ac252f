"""The port's OrderPredictor against the JAX package's on the CPU, the
prep and head variants: the 5-channel prep (f32 and bf16 prep dtype),
the `nbor` pair filter, the masks-only input, the dual occlusion / depth
head, the 3- and 4-class OrderNet head and a siamese_fn. Geometry, bars
and helpers are those of tests/test_torch_pipeline.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from test_torch_pipeline import (_batches, assert_logits_close, hold, net,
                                 pair, scene)

from instaorder_tpu_torch.eval import pipeline as TPL
from instaorder_tpu_torch.models import resnet as tresnet
import torch_threads  # noqa: F401 (the suite's torch thread cap)


def test_pallas5_prep_matches_jax_interpret():
    """prep_impl='pallas5' at the default f32 prep dtype (row 1''; JAX's
    kernel in interpret mode) on a non-8-multiple image, both
    directions."""
    jp, tp = pair('InstaOrderNet_o', prep_impl='pallas5',
                  jkw={'prep_interpret': True})
    image, masks, bboxes = scene(5, h=93, w=121)
    hold(jp, tp, image, masks, bboxes)
    xt = tp._build_batch(torch.from_numpy(image),
                         torch.from_numpy(masks).to(torch.uint8),
                         torch.from_numpy(bboxes),
                         np.zeros((8, 2), np.int32))[0]
    assert xt.dtype == torch.float32


def test_pallas5_bf16_prep_dtype():
    jp, tp = pair('InstaOrderNet_o', prep_impl='pallas5',
                  prep_passes=1, jkw={'prep_interpret': True,
                                      'prep_dtype': jnp.bfloat16})
    tp.prep_dtype = torch.bfloat16
    image, masks, bboxes = scene(6)
    xj, xt, _ = _batches(jp, tp, image, masks, bboxes)
    np.testing.assert_array_equal(xt[..., :2], xj[..., :2])
    d = np.abs(xt[..., 2:] - xj[..., 2:])
    assert d.max() <= 0.03125 + 1e-6 and (d > 0).mean() < 0.01


def test_nbor_pair_filter_matches_jax():
    jp, tp = pair('InstaOrderNet_o')
    image, masks, bboxes = scene(7, n=6)
    masks[1] = 0
    masks[1, 30:50, 40:60] = 1
    masks[2] = 0
    masks[2, 50:70, 40:60] = 1        # touches 1
    hold(jp, tp, image, masks, bboxes, pairs='nbor')
    _, valid, *_ = tp.pair_outputs(image, masks, bboxes, 'nbor')
    assert 0 < int(valid.sum()) < 15


def test_masks_only_input_matches_jax():
    """use_rgb=False: a 2-channel net fed the two mask channels."""
    jp, tp = pair('InstaOrderNet_o', in_channels=2, use_rgb=False)
    hold(jp, tp, *scene(8))


@pytest.mark.parametrize('mode', ['patch', 'resize'])
def test_dual_head_matches_jax(mode):
    """InstaOrderNet_od: occlusion and depth matrices from one forward."""
    jp, tp = pair('InstaOrderNet_od', mode, num_classes=[2, 3])
    t1, t2 = hold(jp, tp, *scene(9, n=5),
                  matrices=('occ', 'depth', 'occ_depth'))
    assert [o.shape for o in t1] == [(16, 2), (16, 3)]


@pytest.mark.parametrize('classes', [3, 4])
def test_ordernet_matches_jax(classes):
    jp, tp = pair('OrderNet', num_classes=classes)
    hold(jp, tp, *scene(classes, n=5))


def test_siamese_fn_matches_swapped_input():
    """A conv1-weight-permuted siamese_fn (both directions from the
    un-swapped batch) gives the generic swapped-concat path's logits."""
    jpar, jst, tpar, tst, cfg = net()

    def siamese_fn(p, s, c, x):
        perm = [1, 0] + list(range(2, p['conv1']['w'].shape[2]))
        p2 = dict(p, conv1=dict(p['conv1'], w=p['conv1']['w'][:, :, perm]))
        return tresnet.apply(p, s, c, x), tresnet.apply(p2, s, c, x)

    base = TPL.OrderPredictor(tresnet.apply, cfg, tpar, tst,
                              'InstaOrderNet_o', input_size=64, device='cpu')
    fold = TPL.OrderPredictor(tresnet.apply, cfg, tpar, tst,
                              'InstaOrderNet_o', input_size=64, device='cpu',
                              siamese_fn=siamese_fn)
    image, masks, bboxes = scene(11)
    b = base.pair_outputs(image, masks, bboxes)
    f = fold.pair_outputs(image, masks, bboxes)
    assert_logits_close(f[2], b[2])
    assert_logits_close(f[3], b[3])
    np.testing.assert_array_equal(fold.infer_occ_order(image, masks, bboxes),
                                  base.infer_occ_order(image, masks, bboxes))
