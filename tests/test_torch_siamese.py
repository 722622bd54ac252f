"""The port's two-direction (siamese) paths against the JAX package on the
CPU: the folded forward with each kernel feature set, the bf16 `parity`
profile, the boundary-int8 `serving-d2` profile and their megasteps, at
the test geometry of tests/test_torch_slice.py (ResNet-50 widths, layers
(2, 2, 1, 1), 64x64 inputs, weights bridged with convert.to_torch).

Bars: f32 logits atol 2e-4 (tests/test_pallas_blocks.py's bar for the
kernel routes of the folded trunk); bf16 and v2 logits within 2% of max
|logit| (bf16 roundings and boundary round() ties differ with the order
of f32 sums), decisions equal wherever the JAX probability is more than
1e-2 from 0.5."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from instaorder_tpu.core.nn import tree_cast as j_tree_cast
from instaorder_tpu.models import folding as JF
from instaorder_tpu.models import quantize as JQ
from instaorder_tpu.models import resnet as jresnet
from instaorder_tpu.ops import pairs as JP
from instaorder_tpu.ops import pallas_blocks

from instaorder_tpu_torch import convert, serving
from instaorder_tpu_torch.core.nn import tree_cast
from instaorder_tpu_torch.models import folding as TF
from instaorder_tpu_torch.models import quantize as TQ
import torch_threads  # noqa: F401 (the suite's torch thread cap)

OUT = 64
FEATURES = [False, True, ('identity', 'down', 'stem')]
KERNELS = ('fused_bottleneck', 'fused_bottleneck_down', 'fused_stem',
           'fused_bottleneck_i8v2_hwnc', 'fused_bottleneck_i8v2_hwnc_stage',
           'fused_bottleneck_down_s2_i8v2_hwnc')


@pytest.fixture(scope='module')
def net():
    params, stats, cfg = jresnet.init(
        jax.random.PRNGKey(0), arch='resnet50', in_channels=5,
        num_classes=2, layers_override=(2, 2, 1, 1))
    folded = jax.device_get(JF.fold_resnet(params, stats, cfg))
    x = np.random.RandomState(0).randn(3, 64, 64, 5).astype(np.float32)
    return folded, cfg, x


@pytest.fixture
def interpret(monkeypatch):
    """Every JAX kernel on these paths in interpret mode."""
    for n in KERNELS:
        orig = getattr(pallas_blocks, n)
        monkeypatch.setattr(pallas_blocks, n,
                            (lambda o: lambda *a, **kw: o(
                                *a, **dict(kw, interpret=True)))(orig))


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-6)
    return float(np.abs(got - want).max()) / scale


def _sure_equal(want1, want2, ij, ji):
    """Decisions of the swap average equal where JAX is sure."""
    s1, s2 = (1.0 / (1.0 + np.exp(-np.asarray(w, np.float64)))
              for w in (want1, want2))
    for p, dec in (((s1[:, 1] + s2[:, 0]) / 2, ij),
                   ((s1[:, 0] + s2[:, 1]) / 2, ji)):
        sure = np.abs(p - 0.5) > 1e-2
        np.testing.assert_array_equal(np.asarray(dec)[sure], p[sure] > 0.5)


@pytest.mark.parametrize('use_pallas', FEATURES)
def test_apply_folded_matches_jax(net, interpret, use_pallas):
    folded, cfg, x = net
    want = JF.apply_folded(folded, cfg, jnp.asarray(x),
                           use_pallas=use_pallas)
    got = TF.apply_folded(convert.to_torch(folded), cfg,
                          torch.from_numpy(x), use_pallas=use_pallas)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


@pytest.mark.parametrize('use_pallas', FEATURES)
def test_apply_folded_siamese_matches_jax(net, interpret, use_pallas):
    folded, cfg, x = net
    w1, w2 = JF.apply_folded_siamese(folded, cfg, jnp.asarray(x),
                                     use_pallas=use_pallas)
    g1, g2 = TF.apply_folded_siamese(convert.to_torch(folded), cfg,
                                     torch.from_numpy(x),
                                     use_pallas=use_pallas)
    assert g1.shape == g2.shape == (3, 2)
    np.testing.assert_allclose(g1.numpy(), np.asarray(w1), atol=2e-4)
    np.testing.assert_allclose(g2.numpy(), np.asarray(w2), atol=2e-4)


@pytest.mark.parametrize('use_pallas', [True, ('identity', 'down', 'stem')])
def test_apply_folded_siamese_bf16_matches_jax(net, interpret, use_pallas):
    """The parity profile's forward: bf16 tree (fc head included), bf16
    compute, f32 logits."""
    folded, cfg, x = net
    jb = j_tree_cast(folded, jnp.bfloat16)
    w1, w2 = JF.apply_folded_siamese(jb, cfg, jnp.asarray(x),
                                     dtype=jnp.bfloat16,
                                     use_pallas=use_pallas)
    tb = tree_cast(convert.to_torch(folded), torch.bfloat16)
    g1, g2 = TF.apply_folded_siamese(tb, cfg, torch.from_numpy(x),
                                     dtype=torch.bfloat16,
                                     use_pallas=use_pallas)
    assert g1.dtype == torch.float32
    for g, w in ((g1, w1), (g2, w2)):
        assert _rel(g.numpy(), w) < 0.02, _rel(g.numpy(), w)
    assert float(np.abs(np.asarray(w1)).max()) > 1e-3


@pytest.mark.parametrize('use_pallas', FEATURES)
def test_siamese_out2_is_the_swapped_input(net, use_pallas):
    folded, cfg, x = net
    tf = convert.to_torch(folded)
    xt = torch.from_numpy(x)
    out1, out2 = TF.apply_folded_siamese(tf, cfg, xt, use_pallas=use_pallas)
    swapped = xt[..., [1, 0, 2, 3, 4]]
    np.testing.assert_allclose(
        out1.numpy(), TF.apply_folded(tf, cfg, xt, use_pallas=use_pallas),
        atol=1e-4)
    np.testing.assert_allclose(
        out2.numpy(), TF.apply_folded(tf, cfg, swapped,
                                      use_pallas=use_pallas), atol=1e-4)


VOCAB_PATHS = {
    'bf16': (TF._pallas_features, JF._PALLAS_DEFAULT),
    'v2': (TQ._v2_features, JQ._PALLAS_DEFAULT_V2),
    'int8c': (TQ._int8_features, JQ._PALLAS_DEFAULT_INT8),
}


def check_feature_vocabulary(path):
    """A path's features: exactly the JAX package's vocabulary (each
    name accepted, the names a path does not use ignored), its default
    set the JAX default, an unknown name refused."""
    features, default = VOCAB_PATHS[path]
    assert TF.PALLAS_VOCAB == JF._PALLAS_VOCAB
    assert features(True) == features('default') == default
    assert features(False) == frozenset()
    assert features(tuple(JF._PALLAS_VOCAB)) == JF._PALLAS_VOCAB
    for name in JF._PALLAS_VOCAB:
        assert features((name,)) == {name}
    with pytest.raises(ValueError, match='unknown pallas feature'):
        features(('hwnc', 'hwnc_v9'))


@pytest.mark.parametrize('path', ['bf16', 'v2', 'int8c'])
def test_pallas_features_refuse_unported(path):
    """Every model path accepts the JAX vocabulary with the JAX defaults
    and refuses a name outside it."""
    check_feature_vocabulary(path)


def _scenes(seed=3, S=2, H=96, W=128, N=3):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 255, (S, H, W, 3)).astype(np.float32)
    masks = np.zeros((S, N, H, W), np.float32)
    bboxes = np.zeros((S, N, 4), np.float32)
    for s in range(S):
        for k in range(N):
            y0, x0 = rng.randint(0, H - 40), rng.randint(0, W - 40)
            hh, ww = rng.randint(15, 40, 2)
            masks[s, k, y0:y0 + hh, x0:x0 + ww] = 1
            bboxes[s, k] = [x0, y0, ww, hh]
    pidx, _ = JP.all_pair_indices(N)
    return images, masks, bboxes, pidx


def _v2(folded, cfg, x):
    scales = JQ.calibrate_folded_resnet(folded, cfg,
                                        [np.asarray(x, np.float32)])
    return JQ.quantize_folded_v2(folded, cfg, scales,
                                 compute_dtype=jnp.float32)


V2_FEATURES = [True, False, ('stem',), ('hwnc', 'down2'),
               ('hwnc', 'down2', 'hwncs1d', 'dirpack', 'stem')]


@pytest.mark.parametrize('use_pallas', V2_FEATURES)
def test_apply_folded_v2_siamese_matches_jax(net, interpret, use_pallas):
    folded, cfg, x = net
    qv2 = _v2(folded, cfg, x)
    w1, w2 = JQ.apply_folded_v2_siamese(qv2, cfg, jnp.asarray(x),
                                        use_pallas=use_pallas)
    q = convert.to_torch(jax.device_get(qv2))
    g1, g2 = TQ.apply_folded_v2_siamese(q, cfg, torch.from_numpy(x),
                                        use_pallas=use_pallas)
    for g, w in ((g1, w1), (g2, w2)):
        assert _rel(g.numpy(), w) < 0.02, _rel(g.numpy(), w)
    assert float(np.abs(np.asarray(w1)).max()) > 1e-3
    ij, ji = serving.decode_occ(g1, g2)
    _sure_equal(w1, w2, ij.numpy(), ji.numpy())
    # direction 0 is apply_folded_v2 itself
    one = TQ.apply_folded_v2(q, cfg, torch.from_numpy(x),
                             use_pallas=use_pallas)
    assert _rel(g1.numpy(), one.numpy()) < 0.02


@pytest.mark.parametrize('use_pallas,calls', [
    (True, (1, 3, 1)), (False, (0, 0, 0)), (('stem',), (0, 0, 0)),
    (('hwnc', 'down2'), (0, 3, 2)), (('down2',), (0, 2, 0)),
    (('hwncs1d',), (1, 0, 1))])
def test_v2_trunk_routes_by_features(net, monkeypatch, use_pallas, calls):
    """The v2 trunk's kernel calls (stage, stride-2 projection, identity)
    per feature set, as the JAX package routes them at layers (2, 2, 1,
    1): an explicit set replaces the default; without 'hwnc' the
    stride-2 kernel keeps to conv1 Cin <= 512 (layer4's projection runs
    plain)."""
    folded, cfg, x = net
    q = convert.to_torch(jax.device_get(_v2(folded, cfg, x)))
    seen = []
    for n in ('fused_bottleneck_i8v2_stage', 'fused_bottleneck_i8v2_down_s2',
              'fused_bottleneck_i8v2_identity'):
        orig = getattr(TQ.bk, n)
        monkeypatch.setattr(TQ.bk, n, (lambda n, o: lambda *a, **kw: (
            seen.append(n), o(*a, **kw))[1])(n, orig))
    out = TQ.apply_folded_v2(q, cfg, torch.from_numpy(x),
                             use_pallas=use_pallas)
    assert out.shape == (3, 2) and torch.isfinite(out).all()
    assert tuple(sum(n.endswith(k) for n in seen)
                 for k in ('stage', 'down_s2', 'identity')) == calls


def _jax_prep(images, masks, bboxes, pidx, route, passes=3):
    """The root bench's prep_all (bench.py:223-239)."""
    pj = jnp.asarray(pidx)
    if route == 'einsum':
        def prep(im, m, b):
            return JP.build_pair_batch_matmul(
                im, m, pj, JP.pair_rois(b, pj), out_size=OUT,
                dtype=jnp.bfloat16, precision=jax.lax.Precision.HIGH)
        x = jax.vmap(prep)(jnp.asarray(images), jnp.asarray(masks),
                           jnp.asarray(bboxes))
        return x.reshape(-1, OUT, OUT, 5)
    rois = jax.vmap(lambda b: JP.pair_rois(b, pj))(jnp.asarray(bboxes))
    return JP.build_pair_batches_fused(
        jnp.asarray(images), jnp.asarray(masks), pj, rois, out_size=OUT,
        dtype=jnp.bfloat16, passes=passes,
        fuse_masks=route == 'pallas5', interpret=True)


def _check_megastep(got, want1, want2):
    (g1, g2), ij, ji = got
    assert g1.shape == g2.shape == (6, 2)
    assert ij.dtype == torch.bool and ji.shape == (6,)
    for g, w in ((g1, want1), (g2, want2)):
        assert _rel(g.numpy(), w) < 0.02, _rel(g.numpy(), w)
    assert float(np.abs(np.asarray(want1)).max()) > 1e-3
    _sure_equal(want1, want2, ij.numpy(), ji.numpy())


@pytest.mark.parametrize('prep_rgb,use_pallas', [
    ('einsum', True), ('pallas', ('identity', 'down', 'stem'))])
def test_parity_megastep_matches_jax(net, interpret, prep_rgb, use_pallas):
    """bench.py --profile parity: the bf16 swap ensemble (bench.py:196-198,
    223-239, 336-345)."""
    folded, cfg, _ = net
    images, masks, bboxes, pidx = _scenes()
    jb = j_tree_cast(folded, jnp.bfloat16)
    x = _jax_prep(images, masks, bboxes, pidx, prep_rgb)
    w1, w2 = JF.apply_folded_siamese(jb, cfg, x, dtype=jnp.bfloat16,
                                     use_pallas=use_pallas)
    prof = serving.resolve_profile('parity', prep_rgb=prep_rgb)
    assert prof == {'dtype': 'bf16', 'directions': 2,
                    'prep_rgb': prep_rgb, 'passes': 3}
    q = tree_cast(convert.to_torch(folded), torch.bfloat16)
    got = serving.megastep(
        q, cfg, torch.from_numpy(images), torch.from_numpy(masks),
        torch.from_numpy(bboxes), pidx, out_size=OUT, passes=3,
        directions=2, prep_rgb=prep_rgb, use_pallas=use_pallas)
    _check_megastep(got, w1, w2)


def test_serving_d2_megastep_matches_jax(net, interpret):
    """bench.py --profile serving-d2: 3-pass 5-channel prep, v2 swap
    ensemble (bench.py:223-239, 307-318)."""
    folded, cfg, _ = net
    images, masks, bboxes, pidx = _scenes(seed=5)
    x = _jax_prep(images, masks, bboxes, pidx, 'pallas5', passes=3)
    qv2 = _v2(folded, cfg, x)
    w1, w2 = JQ.apply_folded_v2_siamese(qv2, cfg, x)
    prof = serving.resolve_profile('serving-d2')
    assert prof == {'dtype': 'int8', 'directions': 2, 'prep_rgb': 'pallas5',
                    'passes': 3}
    q = convert.to_torch(jax.device_get(qv2))
    got = serving.megastep(
        q, cfg, torch.from_numpy(images), torch.from_numpy(masks),
        torch.from_numpy(bboxes), pidx, out_size=OUT, passes=3,
        directions=2, prep_rgb='pallas5')
    _check_megastep(got, w1, w2)


def test_profiles_mirror_the_root_bench():
    import bench
    assert serving.PROFILES == bench.PROFILES
    assert serving.resolve_profile('serving-d1') == {
        'dtype': 'int8', 'directions': 1, 'prep_rgb': 'pallas5',
        'passes': 1}


def test_parity_model_runs_on_cpu():
    images, masks, bboxes, pidx = _scenes(seed=4)
    sc = serving.upload_scenes(images, masks, bboxes, device='cpu')
    q, cfg = serving.build_parity_model(0, device='cpu',
                                        weight_init='kaiming_out')
    assert all(t.dtype == torch.bfloat16 for t in (
        q['conv1']['w'], q['layer4'][0]['down']['b'], q['fc']['w']))
    (o1, o2), ij, ji = serving.megastep(q, cfg, *sc, pidx, out_size=OUT,
                                        directions=2, prep_rgb='einsum')
    assert o1.shape == o2.shape == (6, 2) and o1.dtype == torch.float32
    assert torch.isfinite(o1).all() and torch.isfinite(o2).all()
