"""The port's MiDaS / InstaDepthNet networks against the JAX package on the
CPU: the align-corners resize, the ResNet feature taps (`apply(features=
True)`, `run_stem`, `run_stage`) of the ResNeXt-101 32x8d trunk and the
ResNet-50 order branch, the fusion block, `midas.apply` for the three
variants on JAX's weights carried across with `convert.to_torch`, and the
registry's trees (keys, shapes and cfg equal to JAX's at full width).
Tolerance: 1e-5 of max |JAX|.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instaorder_tpu.models import midas as jmidas
from instaorder_tpu.models import registry as JREG
from instaorder_tpu.models import resnet as jresnet
from instaorder_tpu.ops import resize as jresize

from instaorder_tpu_torch import convert
from instaorder_tpu_torch.models import midas as tmidas
from instaorder_tpu_torch.models import registry as TREG
from instaorder_tpu_torch.models import resnet as tresnet
from instaorder_tpu_torch.ops import resize as tresize

BAR = 1e-5
SMALL = (1, 1, 1, 1)


def close(got, want, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= BAR * scale, (what, err, scale)


def shapes(tree):
    return jax.tree_util.tree_map(lambda v: tuple(np.shape(v)), tree)


def perturb(tree, rng, scale):
    """Every leaf plus a uniform draw (biases and BN statistics leave
    their zero / one init, so no term of the forward is trivially 0)."""
    return jax.tree_util.tree_map(
        lambda v: (np.asarray(v) + rng.uniform(-scale, scale, np.shape(v))
                   ).astype(np.float32), tree)


def positive_stats(stats, rng):
    return jax.tree_util.tree_map(
        lambda v: (np.asarray(v) + rng.uniform(0.1, 0.5, np.shape(v))
                   ).astype(np.float32), stats)


# ---------------------------------------------------------------------------
# resize
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('src,dst', [(7, 14), (6, 12), (1, 5), (5, 1),
                                     (12, 24)])
def test_align_corners_weights_and_upsample_match_jax(src, dst):
    np.testing.assert_array_equal(
        tresize.resize_weights_linear_align_corners(src, dst),
        jresize.resize_weights_linear_align_corners(src, dst))
    x = np.random.RandomState(src * 10 + dst).randn(2, 3, src, src + 2
                                                    ).astype(np.float32)
    want = jresize.upsample_bilinear_align_corners(jnp.asarray(x), dst,
                                                   dst + 3)
    got = tresize.upsample_bilinear_align_corners(torch.from_numpy(x), dst,
                                                  dst + 3)
    close(got, want, 'upsample')
    nhwc = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    for jf, tf in ((jmidas._upsample2x_align, tmidas._upsample2x_align),
                   (jmidas._upsample2x_half_pixel,
                    tmidas._upsample2x_half_pixel)):
        close(tf(torch.from_numpy(nhwc)), jf(jnp.asarray(nhwc)), tf.__name__)


def test_align_corners_matches_torch_interpolate():
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 3, 7, 9)
                         .astype(np.float32))
    want = torch.nn.functional.interpolate(x, scale_factor=2,
                                           mode='bilinear',
                                           align_corners=True)
    got = tresize.upsample_bilinear_align_corners(x, 14, 18)
    assert (got - want).abs().max() <= 1e-6


# ---------------------------------------------------------------------------
# resnet feature taps
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def jax_od(seed=3, features=16):
    """One trimmed JAX InstaDepthNet_od (features 16, one block a stage),
    its biases and BN statistics drawn from a seed and out_conv3's bias
    set so that the disparity is positive on most pixels; numpy trees.
    One JAX init (the slow part of this file) serves all three variants
    (`jax_net`)."""
    box = {}

    def trees(key):     # jitted: JAX draws the weights faster in one program
        p, s, box['cfg'] = jmidas.init(key, features=features,
                                       variant='instadepthnet_od',
                                       trunk_layers=SMALL,
                                       branch_layers=SMALL)
        return p, s
    p, s = jax.jit(trees)(jax.random.PRNGKey(seed))
    cfg = box['cfg']
    rng = np.random.RandomState(seed)
    p = jax.device_get(p)

    def bias(tree):
        if isinstance(tree, dict):
            return {k: (rng.uniform(-0.1, 0.1, v.shape).astype(np.float32)
                        if k == 'b' and not isinstance(v, dict) else bias(v))
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [bias(v) for v in tree]
        return tree
    p = bias(p)
    p['out_conv3'] = dict(p['out_conv3'], b=np.full((1,), 0.5, np.float32))
    return p, positive_stats(jax.device_get(s), rng), cfg


def jax_net(variant):
    """JAX's tree and cfg of `variant` cut from `jax_od`: MidasNet drops
    the branches, InstaDepthNet_d takes `do` as its `gdo`."""
    p, s, cfg = jax_od()
    if variant == 'instadepthnet_od':
        return p, s, cfg
    drop = lambda t: {k: v for k, v in t.items() if k not in ('do', 'oo')}
    p, s = drop(p), drop(s)
    cfg = {k: v for k, v in cfg.items() if k not in ('do_cfg', 'oo_cfg')}
    cfg['variant'] = variant
    if variant == 'instadepthnet_d':
        p['gdo'], s['gdo'] = jax_od()[0]['do'], jax_od()[1]['do']
        cfg['gdo_cfg'] = jax_od()[2]['do_cfg']
    return p, s, cfg


@pytest.mark.parametrize('part', ['trunk', 'branch'])
def test_resnet_feature_taps_match_jax(part):
    """resnet.apply(features=True), run_stem and run_stage on JAX's
    ResNeXt-101 32x8d trunk (3 channels, kaiming) and ResNet-50 order
    branch (2 channels, xavier), headless, one block a stage."""
    p, s, cfg = jax_od()
    if part == 'trunk':
        jp, js, jcfg = p['trunk'], s['trunk'], cfg['trunk_cfg']
        arch, cin, init = 'resnext101_32x8d', 3, 'kaiming_out'
    else:
        jp, js, jcfg = p['do']['net'], s['do']['net'], cfg['do_cfg']
        arch, cin, init = 'resnet50', 2, 'xavier'
    tp, ts = convert.to_torch(jp), convert.to_torch(js)
    p0, s0, tcfg = tresnet.init(torch.Generator().manual_seed(0), arch=arch,
                                in_channels=cin, weight_init=init,
                                with_head=False, layers_override=SMALL)
    assert tcfg == jcfg
    assert shapes(convert.to_numpy(p0)) == shapes(jp)
    assert shapes(convert.to_numpy(s0)) == shapes(js)
    x = np.random.RandomState(1).randn(2, 64, 96, cin).astype(np.float32)
    want, _ = jax.jit(lambda v: jresnet.apply(jp, js, jcfg, v,
                                              features=True))(jnp.asarray(x))
    got = tresnet.apply(tp, ts, tcfg, torch.from_numpy(x), features=True)
    assert sorted(got) == sorted(want)
    for k in want:
        close(got[k], want[k], k)
    h_want, _ = jax.jit(lambda v: jresnet.run_stem(jp, js, v))(
        jnp.asarray(x))
    h_got = tresnet.run_stem(tp, ts, torch.from_numpy(x))
    close(h_got, h_want, 'run_stem')
    for li in range(1, 5):
        h_in = np.array(want['stem' if li == 1 else f'layer{li - 1}'])
        w, _ = jax.jit(lambda v: jresnet.run_stage(jp, js, jcfg, li, v))(
            jnp.asarray(h_in))
        g = tresnet.run_stage(tp, ts, tcfg, li, torch.from_numpy(h_in))
        close(g, w, f'run_stage {li}')
        close(g, want[f'layer{li}'], f'run_stage {li} vs apply')


# ---------------------------------------------------------------------------
# midas
# ---------------------------------------------------------------------------

def test_fusion_block_matches_jax():
    rng = np.random.RandomState(2)
    p = perturb(jax.device_get(jmidas._fusion_init(jax.random.PRNGKey(2),
                                                   8)), rng, 0.1)
    x = rng.randn(2, 6, 5, 8).astype(np.float32)
    skip = rng.randn(2, 6, 5, 8).astype(np.float32)
    tp = convert.to_torch(p)
    for s in (None, skip):
        want = jmidas._fusion_apply(p, jnp.asarray(x),
                                    None if s is None else jnp.asarray(s))
        got = tmidas._fusion_apply(tp, torch.from_numpy(x),
                                   None if s is None else torch.from_numpy(s))
        close(got, want, f'fusion skip={s is not None}')


@pytest.mark.parametrize('variant', tmidas.VARIANTS)
@pytest.mark.parametrize('hw', [(64, 64), (64, 96)])
def test_midas_apply_matches_jax(variant, hw):
    p, s, cfg = jax_net(variant)
    rng = np.random.RandomState(4)
    img = rng.randn(2, *hw, 3).astype(np.float32)
    m1 = (rng.rand(2, *hw) > 0.6).astype(np.float32)
    m2 = (rng.rand(2, *hw) > 0.6).astype(np.float32)
    want, _ = jax.jit(lambda *a: jmidas.apply(p, s, cfg, *a))(
        jnp.asarray(img), jnp.asarray(m1), jnp.asarray(m2))
    tp, ts = convert.to_torch(p), convert.to_torch(s)
    got = tmidas.apply(tp, ts, cfg, torch.from_numpy(img),
                       torch.from_numpy(m1), torch.from_numpy(m2))
    if variant == 'midas':
        want, got = (want,), (got,)
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        if w is None:
            assert g is None
            continue
        close(g, w, f'{variant} output {k}')
    disp = np.asarray(want[0])
    assert disp.shape == (2, *hw)
    assert (disp > 0).mean() > 0.9, 'the disparity is not degenerate'
    close(tmidas.apply_disp(tp, ts, cfg, torch.from_numpy(img)), disp,
          'apply_disp')


@pytest.mark.parametrize('name', TREG.MIDAS_NAMES)
def test_registry_midas_trees_match_jax(name):
    """The registry's three networks at full width (ResNeXt-101 32x8d,
    features 256, ResNet-50 branches): the same keys, shapes and cfg as
    JAX's (JAX's shapes from eval_shape, without drawing its weights)."""
    kw = {'in_channels': 5, 'num_classes': 3}
    jinit = JREG.get_backbone(name)['init']
    box = {}

    def trees(key):
        p, s, box['cfg'] = jinit(key, **kw)
        return p, s
    jp, js = jax.eval_shape(trees, jax.random.PRNGKey(0))
    jcfg = box['cfg']
    bb = TREG.get_backbone(name)
    assert bb['apply'] is tmidas.apply
    p, s, cfg = bb['init'](torch.Generator().manual_seed(0), device='cpu',
                           **kw)
    assert shapes(convert.to_numpy(p)) == shapes(jp)
    assert shapes(convert.to_numpy(s)) == shapes(js)
    assert cfg == jcfg
    n = sum(v.numel() for v in jax.tree_util.tree_leaves(
        p, is_leaf=lambda v: isinstance(v, torch.Tensor)))
    assert n == sum(int(np.prod(v.shape)) for v in
                    jax.tree_util.tree_leaves(jp))
    # the carried tree round-trips leaf for leaf
    back = convert.to_torch(convert.to_numpy(s))
    assert shapes(convert.to_numpy(back)) == shapes(js)
