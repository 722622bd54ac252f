"""The port's OrderPredictor with resnet.apply against the JAX package's
OrderPredictor(resnet.apply) on the CPU, at the small geometry of
tests/test_eval_pipeline.py (ResNet-50 widths, layers (1, 1, 1, 1),
input 64, 4-6 instances on 96x128 scenes), params made in JAX from a
seed and converted with convert.to_torch.

Each case holds three things:
  * the pair batch (`_build_batch`) at the prep bar: masks exact, RGB
    within one uint8 LSB on under 1% of pixels;
  * the forward on the same batch (JAX's, fed to both): f32 logits
    within 1e-5 of max |logit|, both directions;
  * the matrices of the infer_* methods, equal.
The logits are not compared end to end at 1e-5: the two preps' f32
normalisations differ by an ulp on most pixels (XLA compiles (v / 255 -
mean) / std as a fused multiply-add by the reciprocals, PyTorch divides),
and these random nets' logits are ~100x smaller than their features, so
an input ulp moves a logit by up to ~2e-5 of its scale.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from instaorder_tpu.eval import pipeline as JPL
from instaorder_tpu.models import resnet as jresnet

from instaorder_tpu_torch import convert
from instaorder_tpu_torch.eval import pipeline as TPL
from instaorder_tpu_torch.models import resnet as tresnet
import torch_threads  # noqa: F401 (the suite's torch thread cap)

F32_BAR = 1e-5


def scene(seed, n=4, h=96, w=128):
    rng = np.random.RandomState(seed)
    image = rng.randint(0, 255, (h, w, 3)).astype(np.float32)
    masks = np.zeros((n, h, w), np.float32)
    bboxes = np.zeros((n, 4), np.float32)
    for k in range(n):
        y0, x0 = rng.randint(0, h - 40), rng.randint(0, w - 40)
        hh, ww = rng.randint(15, 40), rng.randint(15, 40)
        masks[k, y0:y0 + hh, x0:x0 + ww] = 1
        bboxes[k] = [x0, y0, ww, hh]
    return image, masks, bboxes


_NETS = {}


HEAD_GAIN = 100.0


def net(num_classes=2, in_channels=5):
    """(jax params, stats, torch params, stats, cfg) from PRNGKey(0),
    cached per head and input width (the init runs jitted: ~4 s, not
    ~10 s op by op). The heads' weights and biases are scaled by
    HEAD_GAIN: at the torchvision init these nets' logits are ~5e-3, so
    every probability would lie within 1e-2 of 0.5 and a check of the
    decisions where the reference is sure would check nothing."""
    key = (str(num_classes), in_channels)
    if key not in _NETS:
        kw = dict(arch='resnet50', in_channels=in_channels,
                  num_classes=num_classes, layers_override=(1, 1, 1, 1))
        box = {}

        def init(k):
            p, s, box['cfg'] = jresnet.init(k, **kw)
            return p, s
        params, stats = jax.device_get(jax.jit(init)(jax.random.PRNGKey(0)))
        cfg = box['cfg']
        for fc in ('fc', 'fc_occ', 'fc_depth'):
            if fc in params:
                params[fc] = {k: np.asarray(v) * np.float32(HEAD_GAIN)
                              for k, v in params[fc].items()}
        _NETS[key] = (params, stats, convert.to_torch(params),
                      convert.to_torch(stats), cfg)
    return _NETS[key]


def _flat(out):
    if out is None:
        return []
    return [np.asarray(o) for o in (out if isinstance(out, tuple)
                                    else (out,))]


def assert_logits_close(got, want, bar=F32_BAR):
    for g, w in zip(_flat(got), _flat(want)):
        scale = max(np.abs(w).max(), 1e-6)
        err = np.abs(np.asarray(g, np.float32) - w).max() / scale
        assert err <= bar, err


def _batches(jp, tp, image, masks, bboxes):
    from instaorder_tpu.ops.pairs import all_pair_indices
    n = masks.shape[0]
    pidx, _ = all_pair_indices(n, JPL.bucket_pairs(max(n * (n - 1) // 2, 1)))
    xj, vj = jp._build_batch(jnp.asarray(image, jnp.float32),
                             jnp.asarray(masks), jnp.asarray(bboxes),
                             jnp.asarray(pidx))
    xt, vt = tp._build_batch(torch.from_numpy(image),
                             torch.from_numpy(masks).to(torch.uint8),
                             torch.from_numpy(bboxes), pidx)
    vj = None if vj is None else tuple(int(v) for v in vj)
    assert vt == vj
    return np.array(xj, np.float32), xt.float().numpy(), vj


def hold(jp, tp, image, masks, bboxes, pairs='all', matrices=('occ',)):
    """The three checks of the module docstring for one predictor pair."""
    xj, xt, vhw = _batches(jp, tp, image, masks, bboxes)
    assert xt.shape == xj.shape
    np.testing.assert_array_equal(xt[..., :2], xj[..., :2])
    d = np.abs(xt[..., 2:] - xj[..., 2:])
    assert d.max() <= 1.0 / (255 * 0.224) + 1e-6, d.max()
    assert (d > F32_BAR).mean() < 0.01, (d > F32_BAR).mean()

    _, jvalid, j1, j2, _ = jp._pair_outputs(image, masks, bboxes, pairs)
    _, tvalid, t1, t2, _ = tp.pair_outputs(image, masks, bboxes, pairs)
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    assert (t2 is None) == (j2 is None)
    assert [o.shape for o in _flat(t1) + _flat(t2)] == \
        [o.shape for o in _flat(j1) + _flat(j2)]
    # the forward on JAX's batch
    build = tp._build_batch
    tp._build_batch = lambda *a: (torch.from_numpy(xj), vhw)
    try:
        _, _, s1, s2, _ = tp.pair_outputs(image, masks, bboxes, pairs)
    finally:
        tp._build_batch = build
    assert_logits_close(s1, j1)
    assert_logits_close(s2, j2)

    args = (image, masks, bboxes, pairs)
    if 'occ' in matrices:
        np.testing.assert_array_equal(tp.infer_occ_order(*args),
                                      jp.infer_occ_order(*args))
    if 'depth' in matrices:
        np.testing.assert_array_equal(tp.infer_depth_order(*args),
                                      jp.infer_depth_order(*args))
    if 'occ_depth' in matrices:
        for g, w in zip(tp.infer_occ_depth_order(*args),
                        jp.infer_occ_depth_order(*args)):
            np.testing.assert_array_equal(g, w)
    return t1, t2


def pair(method, mode='patch', num_classes=2, in_channels=5, jkw=None,
         **kw):
    jpar, jst, tpar, tst, cfg = net(num_classes, in_channels)
    size = None if mode == 'orig' else 64
    jp = JPL.OrderPredictor(jresnet.apply, cfg, jpar, jst, method, mode,
                            input_size=size, **kw, **(jkw or {}))
    tp = TPL.OrderPredictor(tresnet.apply, cfg, tpar, tst, method, mode,
                            input_size=size, device='cpu', **kw)
    return jp, tp


@pytest.mark.parametrize('mode', ['patch', 'image', 'resize', 'orig'])
@pytest.mark.parametrize('directions', [2, 1])
def test_modes_and_directions_match_jax(mode, directions):
    jp, tp = pair('InstaOrderNet_o', mode, directions=directions)
    image, masks, bboxes = scene(10 + directions, n=5,
                                 **({'h': 100, 'w': 130} if mode == 'orig'
                                    else {}))
    t1, t2 = hold(jp, tp, image, masks, bboxes)
    assert t1.shape == (16, 2) and (t2 is None) == (directions == 1)


def test_orig_mode_pads_to_the_hw_bucket():
    jp, tp = pair('InstaOrderNet_o', 'orig')
    image, masks, bboxes = scene(2, h=60, w=100)          # -> (64, 96)
    xj, xt, vhw = _batches(jp, tp, image, masks, bboxes)
    assert vhw == (64, 96) and xt.shape[1:3] == (128, 128)
    assert not xt[:, 64:].any() and not xt[:, :, 96:].any()
    hold(jp, tp, image, masks, bboxes)


def test_valid_hw_padded_forward_equals_exact():
    """resnet.apply(valid_hw): a zero-padded batch with its valid region
    gives the exact-size logits, in the port and against JAX."""
    jpar, jst, tpar, tst, cfg = net()
    x = np.random.RandomState(0).randn(2, 64, 96, 5).astype(np.float32)
    xp = np.zeros((2, 128, 128, 5), np.float32)
    xp[:, :64, :96] = x
    exact = tresnet.apply(tpar, tst, cfg, torch.from_numpy(x))
    padded = tresnet.apply(tpar, tst, cfg, torch.from_numpy(xp),
                           valid_hw=(64, 96))
    assert_logits_close(padded, exact.numpy())
    want, _ = jresnet.apply(jpar, jst, cfg, jnp.asarray(xp), train=False,
                            valid_hw=(64, 96))
    assert_logits_close(padded, np.asarray(want))
    # no padding: valid_hw covering the whole input is the plain forward
    full = tresnet.apply(tpar, tst, cfg, torch.from_numpy(x),
                         valid_hw=(64, 96))
    np.testing.assert_array_equal(full.numpy(), exact.numpy())


def test_predictor_refuses_bad_arguments():
    _, _, tpar, tst, cfg = net()
    with pytest.raises(ValueError, match='patch mode only'):
        TPL.OrderPredictor(tresnet.apply, cfg, tpar, tst, 'InstaOrderNet_o',
                           'resize', prep_impl='pallas5', device='cpu')
    with pytest.raises(ValueError, match='directions'):
        TPL.OrderPredictor(tresnet.apply, cfg, tpar, tst, 'InstaOrderNet_o',
                           directions=3, device='cpu')
    tp = TPL.OrderPredictor(tresnet.apply, cfg, tpar, tst, 'InstaOrderNet_o',
                            input_size=64, device='cpu')
    with pytest.raises(ValueError, match='pairs'):
        tp.infer_occ_order(*scene(0), pairs='some')
