"""The port's int8c (fully quantized) path against the JAX package on the
CPU, at the geometry of tests/test_quantize.py (ResNet-50 widths, layers
(2, 2, 1, 1), 64x64 inputs), weights bridged with convert.to_torch.

Bars: the int8 path is integer arithmetic with f32 requant epilogues in
the reference's operation order, so quantized weights, m/b/sxr, every
block's and the stem's int8 output and the trunk's int8 output are held
equal bit for bit, against the XLA int8 oracle and against the Pallas
kernels in interpret mode. Logits go through the f32 head, whose mean
and dot reassociate: within 1e-5 of max |logit|. The megastep is held
to the JAX forward on the port's own prepped tensor (logits within
1e-5), its prep to the prep bar against the JAX fused prep (masks equal,
RGB within one uint8 LSB on under 1% of pixels), and its decisions to
JAX's on JAX's own prep wherever JAX is sure."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from instaorder_tpu.models import folding as JF
from instaorder_tpu.models import quantize as JQ
from instaorder_tpu.models import resnet as jresnet
from instaorder_tpu.ops import pairs as JP
from instaorder_tpu.ops import pallas_blocks

from instaorder_tpu_torch import convert, serving
from instaorder_tpu_torch.models import folding as TF
from instaorder_tpu_torch.models import quantize as TQ
from instaorder_tpu_torch.ops import int8_kernels as IK
from instaorder_tpu_torch.ops import stem_kernels as SK
import torch_threads  # noqa: F401 (the suite's torch thread cap)

OUT = 64
KERNELS = ('fused_bottleneck_int8', 'fused_bottleneck_down_int8',
           'fused_stem_int8', 'fused_bottleneck_int8_hwnc',
           'fused_bottleneck_down_int8_hwnc',
           'fused_bottleneck_down_s2_int8_hwnc')
FEATURES = [(), ('identity', 'down'), ('identity', 'down', 'stem'),
            ('hwnc', 'down', 'stem')]


@pytest.fixture(scope='module')
def net():
    params, stats, cfg = jresnet.init(
        jax.random.PRNGKey(0), arch='resnet50', in_channels=5,
        num_classes=2, layers_override=(2, 2, 1, 1))
    folded = jax.device_get(JF.fold_resnet(params, stats, cfg))
    rng = np.random.RandomState(0)
    x = rng.randn(3, 64, 64, 5).astype(np.float32)
    scales = jax.device_get(JQ.calibrate_folded_resnet(folded, cfg, [x]))
    jq = jax.device_get(JQ.quantize_folded_resnet(folded, cfg, scales))
    return folded, cfg, scales, jq, convert.to_torch(jq), x


@pytest.fixture
def interpret(monkeypatch):
    """Every JAX int8 kernel in interpret mode."""
    for n in KERNELS:
        orig = getattr(pallas_blocks, n)
        monkeypatch.setattr(pallas_blocks, n,
                            (lambda o: lambda *a, **kw: o(
                                *a, **dict(kw, interpret=True)))(orig))


def _eq(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, \
        (got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


def _logits_close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-6)
    assert float(np.abs(got - want).max()) <= 1e-5 * scale, \
        float(np.abs(got - want).max()) / scale
    assert scale > 1e-3


def test_quantize_folded_resnet_matches_jax(net):
    """int8 weights, f32 m/b, sxr, s_out, s_feat and the input scales
    equal the JAX package's bit for bit."""
    folded, cfg, scales, jq, _, _ = net
    got = TQ.quantize_folded_resnet(convert.to_torch(folded), cfg,
                                    convert.to_torch(scales))
    assert got['layer1'][0]['conv2']['w'].dtype == torch.int8
    assert got['layer2'][0]['down']['m'].dtype == torch.float32
    assert isinstance(got['layer1'][1]['sxr'], float)
    assert 'cfg_scales' in got and 'r' not in got['layer1'][1]
    gl = jax.tree_util.tree_leaves_with_path(convert.to_numpy(got))
    wl = jax.tree_util.tree_leaves_with_path(jq)
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (p, g), (_, w) in zip(gl, wl):
        w = np.asarray(w)
        if w.dtype == np.float64:       # the Python-float input scales
            w = w.astype(np.float32)
        _eq(g, w)


def test_convert_round_trips_the_int8c_tree(net):
    _, _, _, jq, tq, _ = net
    assert tq['conv1']['w'].dtype == torch.int8
    assert tq['layer1'][0]['conv1']['m'].dtype == torch.float32
    assert isinstance(tq['s_feat'], float)
    assert isinstance(tq['cfg_scales']['in'], float)
    back = convert.to_numpy(tq)
    _eq(back['layer3'][0]['down']['w'], np.asarray(jq['layer3'][0]['down']['w']))


def test_quantize_input_matches_jax(net):
    _, _, _, jq, tq, x = net
    s_in = jq['cfg_scales']['in']
    for xx in (x, x.astype(jnp.bfloat16).astype(np.float32)):
        _eq(TQ.quantize_input(torch.from_numpy(xx), s_in).numpy(),
            JQ.quantize_input(jnp.asarray(xx), s_in))


def _xla_block(qb, h8, stride):
    """The JAX package's XLA int8 oracle for one block
    (quantize._apply_trunk_int8's plain chain)."""
    acc = JQ._conv_int8(qb['conv1'], h8)
    a8 = JQ._requant(acc, qb['conv1']['m'], qb['conv1']['b'])
    acc = JQ._conv_int8(qb['conv2'], a8, stride=stride, padding=1)
    a8 = JQ._requant(acc, qb['conv2']['m'], qb['conv2']['b'])
    acc3 = JQ._conv_int8(qb['conv3'], a8)
    y = acc3.astype(jnp.float32) * qb['conv3']['m'] + qb['conv3']['b']
    if 'down' in qb:
        accd = JQ._conv_int8(qb['down'], h8, stride=stride)
        iden = accd.astype(jnp.float32) * qb['down']['m'] + qb['down']['b']
    else:
        iden = h8.astype(jnp.float32) * qb['sxr']
    return jnp.clip(jnp.round(jnp.maximum(y + iden, 0.0)), 0, 127
                    ).astype(jnp.int8)


def _jargs(qb):
    a = []
    for c in ('conv1', 'conv2', 'conv3', 'down'):
        if c in qb:
            w = qb[c]['w']
            a += [w if c == 'conv2' else w[0, 0], qb[c]['m'], qb[c]['b']]
    return a


@pytest.fixture(scope='module')
def block_inputs(net):
    """The int8 input of the stem and of layer1[0], layer1[1] and
    layer2[0], from the XLA oracle."""
    _, _, _, jq, _, x = net
    x8 = JQ.quantize_input(jnp.asarray(x), jq['cfg_scales']['in'])
    h0 = JQ._stem_int8(jq, x8)
    h1 = _xla_block(jq['layer1'][0], h0, 1)
    h2 = _xla_block(jq['layer1'][1], h1, 1)
    return {'stem': x8, (1, 0): h0, (1, 1): h1, (2, 0): h2}


# (layer, block, stride): layer1[0] the stride-1 projection, layer1[1]
# an identity block, layer2[0] the stride-2 projection
BLOCKS = [(1, 0, 1), (1, 1, 1), (2, 0, 2)]


@pytest.mark.parametrize('li,bi,stride', BLOCKS)
def test_block_plain_matches_jax(net, block_inputs, li, bi, stride):
    """Each plain block against the XLA chain and the NHWC Pallas kernel
    (fused_bottleneck_int8 / fused_bottleneck_down_int8) in interpret
    mode, bit for bit."""
    _, _, _, jq, tq, _ = net
    h = block_inputs[(li, bi)]
    qb, tb = jq[f'layer{li}'][bi], tq[f'layer{li}'][bi]
    ht = torch.from_numpy(np.array(h))
    if 'down' in qb:
        got = IK.fused_bottleneck_down_int8_plain(ht, *TQ._int8_args(tb),
                                                  stride=stride)
        pal = pallas_blocks.fused_bottleneck_down_int8(
            h, *_jargs(qb), stride=stride, interpret=True)
    else:
        got = IK.fused_bottleneck_int8_plain(ht, *TQ._int8_args(tb),
                                             tb['sxr'])
        pal = pallas_blocks.fused_bottleneck_int8(h, *_jargs(qb), qb['sxr'],
                                                  interpret=True)
    want = _xla_block(qb, h, stride)
    _eq(got.numpy(), want)
    _eq(got.numpy(), pal)
    live = float(((got > 0) & (got < 127)).float().mean())
    assert live > 0.05, live


@pytest.mark.parametrize('li,bi,stride', BLOCKS)
def test_block_plain_matches_hwnc_kernels(net, block_inputs, li, bi, stride):
    """The plain blocks against the hwnc Pallas kernels (rows 19-21) in
    interpret mode on the transposed (H, W, N, C) view, bit for bit."""
    _, _, _, jq, tq, _ = net
    h = block_inputs[(li, bi)]
    qb, tb = jq[f'layer{li}'][bi], tq[f'layer{li}'][bi]
    ht = jnp.transpose(h, (1, 2, 0, 3))
    if 'down' not in qb:
        pal = pallas_blocks.fused_bottleneck_int8_hwnc(
            ht, *_jargs(qb), qb['sxr'], interpret=True)
        got = IK.fused_bottleneck_int8_hwnc(
            torch.from_numpy(np.array(h)), *TQ._int8_args(tb), tb['sxr'])
    else:
        fn = (pallas_blocks.fused_bottleneck_down_s2_int8_hwnc if stride == 2
              else pallas_blocks.fused_bottleneck_down_int8_hwnc)
        pal = fn(ht, *_jargs(qb), interpret=True)
        tfn = (IK.fused_bottleneck_down_s2_int8_hwnc if stride == 2
               else IK.fused_bottleneck_down_int8_hwnc)
        got = tfn(torch.from_numpy(np.array(h)), *TQ._int8_args(tb))
    _eq(got.numpy(), jnp.transpose(pal, (2, 0, 1, 3)))


@pytest.mark.parametrize('wide', [False, True])
def test_stem_plain_matches_jax(net, block_inputs, wide):
    """The plain int8 stem (and the double-width siamese stem) against
    the XLA stem and fused_stem_int8 in interpret mode, bit for bit."""
    _, _, _, jq, tq, _ = net
    x8 = block_inputs['stem']
    c1, t1 = jq['conv1'], tq['conv1']
    if wide:
        sw = JF.swap_conv1_w(c1['w'])
        c1 = {'w': jnp.concatenate([c1['w'], sw], axis=3),
              'm': jnp.concatenate([c1['m'], c1['m']]),
              'b': jnp.concatenate([c1['b'], c1['b']])}
        t1 = TF.siamese_conv1(t1)
    got = SK.fused_stem_int8_plain(torch.from_numpy(np.array(x8)),
                                   t1['w'], t1['m'], t1['b'])
    assert got.shape == (3, 16, 16, 128 if wide else 64)
    _eq(got.numpy(), JQ._stem_int8(dict(jq, conv1=c1), x8))
    _eq(got.numpy(), pallas_blocks.fused_stem_int8(
        x8, c1['w'], c1['m'], c1['b'], interpret=True))
    assert float(((got > 0) & (got < 127)).float().mean()) > 0.05


class _MeanSpy:
    """Stands in for jax.numpy inside the JAX quantize module and keeps
    the argument of every mean: the head's f32(h8) * s_feat."""

    def __init__(self, seen):
        self.seen = seen

    def __getattr__(self, name):
        return getattr(jnp, name)

    def mean(self, a, *args, **kw):
        self.seen.append(np.asarray(a))
        return jnp.mean(a, *args, **kw)


def _jax_features(monkeypatch, fn, n):
    """JAX `fn()` and the int8 trunk output's f32(h8) * s_feat in NHWC
    (the hwnc route ends in the (H, W, N, C) view with N padded to 8)."""
    seen = []
    monkeypatch.setattr(JQ, 'jnp', _MeanSpy(seen))
    out = fn()
    monkeypatch.setattr(JQ, 'jnp', jnp)
    feat = seen[-1]
    if feat.shape[0] != n:
        feat = feat.transpose(2, 0, 1, 3)[:n]
    return out, feat


@pytest.mark.parametrize('use_pallas', FEATURES)
def test_apply_folded_int8_matches_jax(net, interpret, monkeypatch,
                                       use_pallas):
    """apply_folded_int8 for each feature set: the trunk's int8 output
    equal to JAX's (XLA oracle and interpret-mode kernels), logits
    within 1e-5 of max |logit|."""
    _, cfg, _, jq, tq, x = net
    want, jfeat = _jax_features(monkeypatch, lambda: JQ.apply_folded_int8(
        jq, cfg, jnp.asarray(x), use_pallas=use_pallas), 3)
    xt = torch.from_numpy(x)
    got = TQ.apply_folded_int8(tq, cfg, xt, use_pallas=use_pallas)
    h8 = TQ._trunk_int8(tq, cfg, TQ._stem_int8(
        tq, TQ.quantize_input(xt, tq['cfg_scales']['in']),
        use_pallas=use_pallas), use_pallas=use_pallas)
    _eq((h8.float() * tq['s_feat']).numpy(), jfeat)
    _logits_close(got.numpy(), want)
    # the oracle itself: every route computes the same integers
    _logits_close(got.numpy(), JQ.apply_folded_int8(
        jq, cfg, jnp.asarray(x), use_pallas=False))


@pytest.mark.parametrize('use_pallas', [(), ('hwnc', 'down', 'stem')])
def test_apply_folded_int8_siamese_matches_jax(net, interpret, use_pallas):
    _, cfg, _, jq, tq, x = net
    w1, w2 = JQ.apply_folded_int8_siamese(jq, cfg, jnp.asarray(x),
                                          use_pallas=use_pallas)
    xt = torch.from_numpy(x)
    g1, g2 = TQ.apply_folded_int8_siamese(tq, cfg, xt, use_pallas=use_pallas)
    assert g1.shape == g2.shape == (3, 2)
    _logits_close(g1.numpy(), w1)
    _logits_close(g2.numpy(), w2)
    # out1 is the one-direction forward, out2 the forward on the input
    # with mask channels 0, 1 exchanged
    _logits_close(g1.numpy(), TQ.apply_folded_int8(tq, cfg, xt,
                                                   use_pallas=use_pallas))
    _logits_close(g2.numpy(), TQ.apply_folded_int8(
        tq, cfg, xt[..., [1, 0, 2, 3, 4]], use_pallas=use_pallas))


def _scenes(seed, S=2, H=96, W=128, N=3):
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


@pytest.mark.parametrize('profile', ['serving-d1', 'serving-d2'])
def test_int8c_megastep_matches_jax(net, interpret, profile):
    """bench.py --profile P --dtype int8c: the fused 5-channel prep, the
    model calibrated on it, the int8c forward with the default kernels
    (root bench.py:223-244, 285-318)."""
    folded, cfg, _, _, _, _ = net
    images, masks, bboxes, pidx = _scenes(seed=6)
    prof = serving.resolve_profile(profile, dtype='int8c')
    pj = jnp.asarray(pidx)
    rois = jax.vmap(lambda b: JP.pair_rois(b, pj))(jnp.asarray(bboxes))
    x = JP.build_pair_batches_fused(
        jnp.asarray(images), jnp.asarray(masks), pj, rois, out_size=OUT,
        dtype=jnp.bfloat16, passes=prof['passes'], fuse_masks=True,
        interpret=True)
    scales = JQ.calibrate_folded_resnet(folded, cfg,
                                        [np.asarray(x, np.float32)])
    jq = jax.device_get(JQ.quantize_folded_resnet(folded, cfg, scales))
    tq = convert.to_torch(jq)
    d2 = prof['directions'] == 2
    fwd = JQ.apply_folded_int8_siamese if d2 else JQ.apply_folded_int8
    want = fwd(jq, cfg, x)
    logits, ij, ji = serving.megastep(
        tq, cfg, torch.from_numpy(images), torch.from_numpy(masks),
        torch.from_numpy(bboxes), pidx, out_size=OUT, passes=prof['passes'],
        directions=prof['directions'], prep_rgb=prof['prep_rgb'])
    gots = logits if d2 else (logits,)
    wants = want if d2 else (want,)
    # the port's plain prep against the JAX fused prep: masks equal, RGB
    # within one uint8 LSB (one bf16 step after normalisation) on under
    # 1% of pixels
    xp = serving.prep_pairs(torch.from_numpy(images), torch.from_numpy(masks),
                            torch.from_numpy(bboxes), pidx, out_size=OUT,
                            passes=prof['passes'], prep_rgb=prof['prep_rgb'])
    xj = np.asarray(x, np.float32)
    np.testing.assert_array_equal(xp[..., :2].float().numpy(), xj[..., :2])
    d = np.abs(xp[..., 2:].float().numpy() - xj[..., 2:])
    assert d.max() <= 0.03125 + 1e-6 and (d > 0).mean() < 0.01
    # the megastep equals the JAX forward on the port's own prepped
    # tensor bit for bit up to the head
    same = fwd(jq, cfg, jnp.asarray(xp.float().numpy()).astype(jnp.bfloat16))
    for g, w in zip(gots, same if d2 else (same,)):
        assert g.shape == (6, 2)
        _logits_close(g.numpy(), w)
    # decisions equal where JAX (on its own prep) is sure: a prep LSB
    # moves x8 and, through every requantised layer of a random net,
    # the logits by up to a few percent
    s = [1.0 / (1.0 + np.exp(-np.asarray(w, np.float64))) for w in wants]
    p_ij, p_ji = ((s[0][:, 1] + s[1][:, 0]) / 2,
                  (s[0][:, 0] + s[1][:, 1]) / 2) if d2 else \
        (s[0][:, 1], s[0][:, 0])
    for p, dec in ((p_ij, ij.numpy()), (p_ji, ji.numpy())):
        sure = np.abs(p - 0.5) > 1e-2
        np.testing.assert_array_equal(dec[sure], p[sure] > 0.5)


@pytest.mark.parametrize('use_pallas,calls', [
    # (identity 16, down 17, stem 18, hwnc identity 19, hwnc down s1 20,
    #  hwnc down s2 21, plain blocks) at layers (2, 2, 1, 1)
    (True, (2, 4, 0, 0, 0, 0, 0)),
    (False, (0, 0, 0, 0, 0, 0, 6)),
    (('identity', 'down', 'stem'), (2, 4, 1, 0, 0, 0, 0)),
    (('hwnc', 'down', 'stem'), (0, 0, 1, 2, 1, 3, 0)),
    (('hwnc',), (0, 0, 0, 2, 0, 0, 4)),
    (('identity',), (2, 0, 0, 0, 0, 0, 4)),
    (('down', 'stem'), (0, 4, 1, 0, 0, 0, 2)),
])
def test_int8c_routes_by_features(net, monkeypatch, use_pallas, calls):
    """The kernel wrapper and plain-route calls per feature set, as the
    JAX package routes the int8c trunk: every route computes the same
    integers, so only the counts can show which one ran."""
    _, cfg, _, _, tq, x = net
    names = ('fused_bottleneck_int8', 'fused_bottleneck_down_int8',
             'fused_stem_int8', 'fused_bottleneck_int8_hwnc',
             'fused_bottleneck_down_int8_hwnc',
             'fused_bottleneck_down_s2_int8_hwnc', '_plain_block_int8')
    seen = {n: 0 for n in names}

    def spy(n, orig):
        def f(*a, **kw):
            seen[n] += 1
            return orig(*a, **kw)
        return f

    for n in names:
        mod = TQ if n in ('fused_stem_int8', '_plain_block_int8') else TQ.ik
        monkeypatch.setattr(mod, n, spy(n, getattr(mod, n)))
    out = TQ.apply_folded_int8(tq, cfg, torch.from_numpy(x),
                               use_pallas=use_pallas)
    assert out.shape == (3, 2) and torch.isfinite(out).all()
    assert tuple(seen[n] for n in names) == calls


def test_int8c_features_refuse_unported():
    """The int8c path's vocabulary is the JAX package's (with 'hwnc,down2'
    legal: 'down2' is a v2 name the path ignores), its default JAX's."""
    assert TQ._int8_features(True) == JQ._PALLAS_DEFAULT_INT8
    assert TQ._int8_features(False) == frozenset()
    assert TQ._int8_features(tuple(JF._PALLAS_VOCAB)) == JF._PALLAS_VOCAB
    assert TQ._int8_features(('hwnc', 'down2')) == {'hwnc', 'down2'}
    with pytest.raises(ValueError, match='unknown pallas feature'):
        TQ._int8_features(('hwnc', 'hwnc_v9'))


@pytest.mark.parametrize('profile', sorted(serving.PROFILES))
@pytest.mark.parametrize('dtype', [None, 'int8c', 'int8', 'bf16', 'f32'])
def test_dtype_resolution_mirrors_the_root_bench(profile, dtype):
    import bench
    argv = ['--profile', profile] + (['--dtype', dtype] if dtype else [])
    want = bench.resolve_profile(bench.build_parser().parse_args(argv))
    got = serving.resolve_profile(profile, dtype=dtype)
    assert got == {'dtype': want.dtype, 'directions': want.directions,
                   'prep_rgb': want.prep_rgb,
                   'passes': 1 if want.prep_precision == 'default' else 3}


def test_port_bench_dtype_flag():
    from instaorder_tpu_torch import bench as tbench
    args = tbench.build_parser().parse_args(['--dtype', 'int8c'])
    assert args.dtype == 'int8c' and args.profile == 'serving-d1'
    assert tbench.build_parser().parse_args([]).dtype is None
    # --dtype f32 is a choice since the f32 kernels; a name outside the
    # root bench's four is refused
    assert tbench.build_parser().parse_args(['--dtype', 'f32']).dtype == 'f32'
    with pytest.raises(SystemExit):
        tbench.build_parser().parse_args(['--dtype', 'fp16'])
    with pytest.raises(ValueError, match='dtype'):
        serving.resolve_profile('serving-d1', dtype='fp16')


def test_int8c_model_runs_on_cpu():
    images, masks, bboxes, pidx = _scenes(seed=4, H=160, W=200)
    sc = serving.upload_scenes(images, masks, bboxes, device='cpu')
    x = serving.prep_pairs(*sc, pidx, out_size=OUT)
    q, cfg = serving.build_model('serving-d2', 0, x, device='cpu',
                                 weight_init='kaiming_out', dtype='int8c')
    assert q['conv1']['w'].dtype == torch.int8 and 'cfg_scales' in q
    (o1, o2), ij, ji = serving.megastep(q, cfg, *sc, pidx, out_size=OUT,
                                        passes=3, directions=2)
    assert o1.shape == o2.shape == (6, 2) and torch.isfinite(o1).all()
    assert ij.dtype == torch.bool and ji.shape == (6,)
