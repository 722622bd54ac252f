"""instaorder_tpu_torch core layers, ResNet forward, BN folding, the weight
bridge and the occlusion decode against the JAX package on the CPU.

Bar (f32 paths): |port - jax| <= 1e-5 x the output scale, the
tests/test_goldens.py bar; both sides compute in f32 and differ only in
the order of their sums."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from instaorder_tpu.core import nn as jnn
from instaorder_tpu.eval import decode as jdecode
from instaorder_tpu.models import folding as jfolding
from instaorder_tpu.models import resnet as jresnet

from instaorder_tpu_torch import convert
from instaorder_tpu_torch.core import nn as tnn
from instaorder_tpu_torch.eval import decode as tdecode
from instaorder_tpu_torch.models import folding as tfolding
from instaorder_tpu_torch.models import resnet as tresnet
import torch_threads  # noqa: F401 (the suite's torch thread cap)

torch.backends.cudnn.allow_tf32 = False


def _close(got, want, rel=1e-5):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-6)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max() <= rel * scale, \
        np.abs(got - want).max() / scale


@pytest.fixture(scope='module')
def jax_net():
    params, stats, cfg = jresnet.init(
        jax.random.PRNGKey(0), arch='resnet50', in_channels=5,
        num_classes=2, layers_override=(2, 2, 1, 1))
    # non-trivial BN statistics so folding is exercised
    rng = np.random.RandomState(3)
    stats = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.abs(rng.randn(*a.shape)) + 0.5,
                              jnp.float32), stats)
    params = jax.device_get(params)
    stats = jax.device_get(stats)
    return params, stats, cfg


@pytest.mark.parametrize('stride,padding,k', [(1, 0, 1), (2, 3, 7),
                                              (2, 1, 3)])
def test_conv2d_matches_jax(stride, padding, k):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 16, 16, 8).astype(np.float32)
    p = {'w': rng.randn(k, k, 8, 16).astype(np.float32),
         'b': rng.randn(16).astype(np.float32)}
    want = jnn.conv2d(jax.tree_util.tree_map(jnp.asarray, p),
                      jnp.asarray(x), stride=stride, padding=padding)
    got = tnn.conv2d(convert.to_torch(p), torch.from_numpy(x),
                     stride=stride, padding=padding)
    _close(got, want)


def test_max_pool_matches_jax():
    rng = np.random.RandomState(1)
    x = (rng.randn(2, 9, 10, 3) * 50).astype(np.float32)
    want = np.asarray(jnn.max_pool(jnp.asarray(x), 3, 2, 1))
    got = tnn.max_pool(torch.from_numpy(x), 3, 2, 1).numpy()
    np.testing.assert_array_equal(got, want)


def test_linear_and_bn_eval_match_jax():
    rng = np.random.RandomState(2)
    x = rng.randn(4, 6, 6, 8).astype(np.float32)
    p = {'w': rng.randn(8, 3).astype(np.float32),
         'b': rng.randn(3).astype(np.float32)}
    _close(tnn.linear(convert.to_torch(p), torch.from_numpy(x)),
           jnn.linear(p, jnp.asarray(x)))
    bp = {'scale': rng.rand(8).astype(np.float32) + 0.5,
          'bias': rng.randn(8).astype(np.float32)}
    bs = {'mean': rng.randn(8).astype(np.float32),
          'var': rng.rand(8).astype(np.float32) + 0.5}
    want, _ = jnn.batch_norm(bp, bs, jnp.asarray(x), train=False)
    got = tnn.batch_norm_eval(convert.to_torch(bp), convert.to_torch(bs),
                              torch.from_numpy(x))
    _close(got, want)


def test_init_shapes_and_xavier_std_match_jax():
    """The port draws its own random bits, so the trees must agree in
    structure, shapes and the initialiser's scale, not in values."""
    jp, js, jcfg = jresnet.init(jax.random.PRNGKey(0), arch='resnet50',
                                in_channels=5, num_classes=2,
                                weight_init='xavier',
                                layers_override=(2, 2, 1, 1))
    tp, ts, tcfg = tresnet.init(torch.Generator().manual_seed(0),
                                arch='resnet50', in_channels=5,
                                num_classes=2, weight_init='xavier',
                                layers_override=(2, 2, 1, 1))
    assert tcfg == jcfg
    jl = jax.tree_util.tree_leaves_with_path(jax.device_get((jp, js)))
    tl = jax.tree_util.tree_leaves_with_path(convert.to_numpy((tp, ts)))
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (_, a), (_, b) in zip(jl, tl):
        assert a.shape == b.shape
    w = tp['layer3'][0]['conv2']['w']
    want_std = 0.02 * np.sqrt(2.0 / (9 * 256 + 9 * 256))
    assert abs(float(w.std()) / want_std - 1) < 0.05


def test_resnet_apply_matches_jax(jax_net):
    params, stats, cfg = jax_net
    x = np.random.RandomState(4).randn(2, 64, 64, 5).astype(np.float32)
    want, _ = jresnet.apply(params, stats, cfg, jnp.asarray(x))
    got = tresnet.apply(convert.to_torch(params), convert.to_torch(stats),
                        cfg, torch.from_numpy(x))
    _close(got, want)


def test_fold_resnet_matches_jax(jax_net):
    params, stats, cfg = jax_net
    want = jax.device_get(jfolding.fold_resnet(params, stats, cfg))
    got = convert.to_numpy(tfolding.fold_resnet(
        convert.to_torch(params), convert.to_torch(stats), cfg))
    wl = jax.tree_util.tree_leaves_with_path(want)
    gl = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in wl] == [p for p, _ in gl]
    for (_, a), (_, b) in zip(wl, gl):
        _close(b, a)
    w = np.asarray(want['conv1']['w'])
    np.testing.assert_array_equal(
        convert.to_numpy(tfolding.swap_conv1_w(torch.from_numpy(w.copy()))),
        np.asarray(jfolding.swap_conv1_w(w)))


def test_weight_bridge_round_trip(jax_net):
    params, stats, _ = jax_net
    tree = {'p': params, 's': stats, 'r': np.float32(0.75),
            'bf': np.asarray(jnp.asarray([1.5, -2.25, 3.0], jnp.bfloat16))}
    t = convert.to_torch(tree)
    assert isinstance(t['r'], float) and t['r'] == 0.75
    assert t['bf'].dtype == torch.bfloat16
    back = convert.to_numpy(t)
    np.testing.assert_array_equal(back['bf'], [1.5, -2.25, 3.0])
    for (pa, a), (pb, b) in zip(
            jax.tree_util.tree_leaves_with_path({'p': params, 's': stats}),
            jax.tree_util.tree_leaves_with_path(
                {'p': back['p'], 's': back['s']})):
        assert pa == pb
        np.testing.assert_array_equal(a, b)
    assert back['r'] == np.float32(0.75)


def test_decode_matches_jax():
    rng = np.random.RandomState(5)
    out1 = rng.randn(6, 2).astype(np.float32)
    out2 = rng.randn(6, 2).astype(np.float32)
    for o2 in (None, out2):
        t2 = None if o2 is None else torch.from_numpy(o2)
        j2 = None if o2 is None else jnp.asarray(o2)
        for got, want in zip(tdecode.decode_occ(torch.from_numpy(out1), t2),
                             jdecode.decode_occ(jnp.asarray(out1), j2)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    pidx = np.array([[0, 1], [0, 2], [1, 2], [0, 0]], np.int32)
    ij = np.array([True, False, True, True])
    ji = np.array([False, True, True, True])
    valid = np.array([True, True, True, False])
    want = jdecode.occ_matrix(3, jnp.asarray(pidx), jnp.asarray(ij),
                              jnp.asarray(ji), jnp.asarray(valid))
    got = tdecode.occ_matrix(3, pidx, torch.from_numpy(ij),
                             torch.from_numpy(ji), valid)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
