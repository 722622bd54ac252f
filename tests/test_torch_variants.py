"""The v2 (boundary-int8) path's remaining kernel features against the JAX
package on the CPU: the plain versions of kernels 6-9 and of kernel 2's
identity-run mode against the Pallas kernels in interpret mode, the
'stem2' / 'qpool' stems, the routing of every feature set, and the
folded v2 forward with each new feature set.

Bars: each block within one int8 LSB on under 1% of outputs (f32 sums in
another order move rare round() ties); a chain of k blocks in one call
within k LSB on under 1% (the hwncp stage's packed contraction also
reassociates); 'qpool' equal on every value, 'stem2' within one LSB on
under 1%; logits within 2% of max |logit|, decisions equal wherever the
JAX probability is more than 1e-2 from 0.5. Block inputs are int8 planes
at H = W = 16 (the JAX hwnc kernels take the (H, W, N, C) view; inputs
and outputs are transposed to compare); the nets are ResNet-50 widths at
layers (3, 2, 2, 2), 64x64 inputs, f32 compute."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from instaorder_tpu.models import folding as JF
from instaorder_tpu.models import quantize as JQ
from instaorder_tpu.models import resnet as jresnet
from instaorder_tpu.ops import pallas_blocks as PB

from instaorder_tpu_torch import convert, serving
from instaorder_tpu_torch.models import folding as TF
from instaorder_tpu_torch.models import quantize as TQ
from instaorder_tpu_torch.ops import bottleneck_kernels as BK
import torch_threads  # noqa: F401 (the suite's torch thread cap)

N, H = 3, 16
JAX_KERNELS = ('fused_bottleneck_i8v2_hwnc', 'fused_bottleneck_i8v2_hwnc_stage',
               'fused_bottleneck_down_s2_i8v2_hwnc',
               'fused_bottleneck_i8v2_hwncp_stage',
               'fused_bottleneck_down_i8v2_hwnc', 'fused_bottleneck_i8v2',
               'fused_bottleneck_down_i8v2', 'fused_stem')
# the new feature sets of the v2 path (the root bench's --pallas-features)
FEATURE_SETS = [('hwnc', 'down2', 'hwncp', 'dirpack'),
                ('hwnc', 'down1', 'down2'),
                ('hwnc', 'down1', 'down2', 'hwncs'),
                ('hwnc', 'down1', 'down2', 'hwncs', 'hwncs1'),
                ('identity', 'down1'),
                ('identity', 'down1', 'stem2', 'qpool')]


def _w(rng, shape, scale):
    return rng.randn(*shape).astype(np.float32) * scale


def _params(rng, cin, cm, cout, down):
    """tests/test_torch_bottleneck.py's block: about half of the outputs
    inside 1..126 for int8 inputs."""
    p = [_w(rng, (cin, cm), 0.6 / np.sqrt(cin) / 40),
         rng.randn(cm).astype(np.float32) * 0.2,
         _w(rng, (3, 3, cm, cm), 1.2 / np.sqrt(9 * cm)),
         rng.randn(cm).astype(np.float32) * 0.2,
         _w(rng, (cm, cout), 40.0 / np.sqrt(cm)),
         rng.randn(cout).astype(np.float32) * 5.0]
    if down:
        p += [_w(rng, (cin, cout), 1.0 / np.sqrt(cin)),
              rng.randn(cout).astype(np.float32) * 5.0]
    return p


def _both(p):
    p = [np.asarray(a, np.float32) for a in p]
    return [jnp.asarray(a) for a in p], [torch.from_numpy(a) for a in p]


def _x(rng, c, n=N):
    return rng.randint(0, 128, (n, H, H, c)).astype(np.int8)


def _to_hwnc(x):
    return jnp.asarray(np.transpose(x, (1, 2, 0, 3)))


def _from_hwnc(y):
    return np.transpose(np.asarray(y, np.float32), (2, 0, 1, 3))


def _compare(got, want, bar=1):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    d = np.abs(got.astype(np.float64) - want)
    assert d.max() <= bar, d.max()
    assert (d > 0).mean() < 0.01, (d > 0).mean()
    inner = ((want > 0) & (want < 127)).mean()
    assert inner > 0.2, f'degenerate test data: {inner:.2f} unclipped'


@pytest.mark.parametrize('out_int8', [True, False])
def test_down_i8v2_hwnc_plain_matches_pallas(out_int8):
    """Kernel 7: the stride-1 projection, K-packed, on the hwnc view."""
    rng = np.random.RandomState(11)
    x = _x(rng, 64)
    jp, tp = _both(_params(rng, 64, 16, 128, True))
    want = _from_hwnc(PB.fused_bottleneck_down_i8v2_hwnc(
        _to_hwnc(x), *jp, interpret=True, out_int8=out_int8))
    got = BK.fused_bottleneck_down_i8v2_hwnc(torch.from_numpy(x), *tp,
                                             out_int8=out_int8)
    assert got.dtype == (torch.int8 if out_int8 else torch.float32)
    _compare(got, want)


@pytest.mark.parametrize('cin,cm', [(64, 16), (128, 32)])
def test_i8v2_plain_matches_pallas(cin, cm):
    """Kernel 8: the NHWC identity block."""
    rng = np.random.RandomState(cin)
    x = _x(rng, cin)
    jp, tp = _both(_params(rng, cin, cm, cin, False))
    want = PB.fused_bottleneck_i8v2(jnp.asarray(x), *jp, 0.41,
                                    interpret=True)
    got = BK.fused_bottleneck_i8v2(torch.from_numpy(x), *tp, 0.41)
    assert got.dtype == torch.int8
    _compare(got, want)


@pytest.mark.parametrize('out_int8', [True, False])
def test_down_i8v2_plain_matches_pallas(out_int8):
    """Kernel 9: the NHWC stride-1 projection, conv3 and the projection
    as two dots."""
    rng = np.random.RandomState(13)
    x = _x(rng, 64)
    jp, tp = _both(_params(rng, 64, 16, 128, True))
    want = PB.fused_bottleneck_down_i8v2(jnp.asarray(x), *jp,
                                         interpret=True, out_int8=out_int8)
    got = BK.fused_bottleneck_down_i8v2(torch.from_numpy(x), *tp,
                                        out_int8=out_int8)
    _compare(got, want)


def _stage_params(seed, cin, cact, nblocks):
    rng = np.random.RandomState(seed)
    x = _x(rng, cin, n=2)
    down = _params(rng, cin, 16, cact, True) if cin != cact else None
    blocks = [_params(rng, cact, 16, cact, False) for _ in range(nblocks)]
    rs = [0.4, 0.6, 0.5][:nblocks]
    return x, down, blocks, rs


def test_hwncp_stage_plain_matches_pallas():
    """Kernel 6: layer1 (the projection then two identity blocks) on the
    parity-split view with lane-packed 3x3s: a chain of 3 blocks."""
    x, down, blocks, rs = _stage_params(14, 32, 64, 2)
    jd, td = _both(down)
    jb, tb = zip(*[_both(b) for b in blocks])
    want = _from_hwnc(PB.fused_bottleneck_i8v2_hwncp_stage(
        _to_hwnc(x), *jd, *[a for b in jb for a in b],
        jnp.asarray(rs, jnp.float32), nblocks=2, interpret=True))
    got = BK.fused_bottleneck_i8v2_hwncp_stage(torch.from_numpy(x), td,
                                               list(tb), rs)
    assert got.dtype == torch.int8
    _compare(got, want, bar=3)
    with pytest.raises(ValueError, match='projection'):
        BK.fused_bottleneck_i8v2_hwncp_stage(torch.from_numpy(x), None,
                                             list(tb), rs)


@pytest.mark.parametrize('nblocks,out_int8', [(3, True), (2, False)])
def test_identity_run_stage_plain_matches_pallas(nblocks, out_int8):
    """Kernel 2's down=False mode (the 'hwncs' / 'hwncs1' stages): an
    identity run of k blocks in one call, within k LSB."""
    x, _, blocks, rs = _stage_params(15 + nblocks, 64, 64, nblocks)
    jb, tb = zip(*[_both(b) for b in blocks])
    want = _from_hwnc(PB.fused_bottleneck_i8v2_hwnc_stage(
        _to_hwnc(x), *[a for b in jb for a in b],
        jnp.asarray(rs, jnp.float32), nblocks=nblocks, down=False,
        staging='act', out_int8=out_int8, interpret=True))
    got = BK.fused_bottleneck_i8v2_stage(torch.from_numpy(x), None,
                                         list(tb), rs, out_int8=out_int8)
    assert got.dtype == (torch.int8 if out_int8 else torch.float32)
    _compare(got, want, bar=nblocks)


# ---------------------------------------------------------------------------
# the folded v2 forward
# ---------------------------------------------------------------------------


@pytest.fixture(scope='module')
def net():
    params, stats, cfg = jresnet.init(
        jax.random.PRNGKey(0), arch='resnet50', in_channels=5,
        num_classes=2, layers_override=(3, 2, 2, 2))
    folded = jax.device_get(JF.fold_resnet(params, stats, cfg))
    x = np.random.RandomState(0).randn(N, 64, 64, 5).astype(np.float32)
    scales = JQ.calibrate_folded_resnet(folded, cfg, [x])
    qv2 = jax.device_get(JQ.quantize_folded_v2(folded, cfg, scales,
                                               compute_dtype=jnp.float32))
    return qv2, convert.to_torch(qv2), cfg, x


@pytest.fixture
def interpret(monkeypatch):
    """Every JAX kernel of the v2 path in interpret mode."""
    for n in JAX_KERNELS:
        orig = getattr(PB, n)
        monkeypatch.setattr(PB, n, (lambda o: lambda *a, **kw: o(
            *a, **dict(kw, interpret=True)))(orig))


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-6)
    return float(np.abs(got - want).max()) / scale


def test_s2d_helpers_match_jax():
    rng = np.random.RandomState(3)
    w = rng.randn(7, 7, 5, 8).astype(np.float32)
    x = rng.randn(2, 10, 14, 5).astype(np.float32)
    np.testing.assert_array_equal(TF.s2d_conv1_w(torch.from_numpy(w)).numpy(),
                                  np.asarray(JF.s2d_conv1_w(jnp.asarray(w))))
    np.testing.assert_array_equal(
        TF.s2d_stem_input(torch.from_numpy(x)).numpy(),
        np.asarray(JF.s2d_stem_input(jnp.asarray(x))))


@pytest.mark.parametrize('feats', [('qpool',), ('stem2',),
                                   ('stem2', 'qpool')])
def test_stem_v2_routes_match_jax(net, feats):
    """'qpool' (requant before the pool) equals JAX and the plain stem on
    every value; 'stem2' (the space-to-depth conv) is within one LSB of
    JAX's on under 1% of values."""
    jq, tq, _, x = net
    want = np.asarray(JQ._stem_v2(jq, jnp.asarray(x), use_pallas=feats))
    got = TQ._stem_v2(tq, torch.from_numpy(x), use_pallas=feats)
    assert got.dtype == torch.int8 and got.shape == want.shape
    d = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
    if 'stem2' in feats:
        assert d.max() <= 1 and (d > 0).mean() < 0.01, (d.max(),
                                                        (d > 0).mean())
    else:
        np.testing.assert_array_equal(d, 0)
        np.testing.assert_array_equal(
            got.numpy(), TQ._stem_v2(tq, torch.from_numpy(x),
                                     use_pallas=False).numpy())
    assert ((want > 0) & (want < 127)).mean() > 0.2


@pytest.mark.parametrize('use_pallas', FEATURE_SETS)
def test_apply_folded_v2_matches_jax(net, interpret, use_pallas):
    jq, tq, cfg, x = net
    want = JQ.apply_folded_v2(jq, cfg, jnp.asarray(x), use_pallas=use_pallas)
    got = TQ.apply_folded_v2(tq, cfg, torch.from_numpy(x),
                             use_pallas=use_pallas)
    assert got.shape == (N, 2)
    assert _rel(got.numpy(), want) < 0.02, _rel(got.numpy(), want)
    assert float(np.abs(np.asarray(want)).max()) > 1e-3


@pytest.mark.parametrize('use_pallas', FEATURE_SETS[:1] + FEATURE_SETS[3:])
def test_apply_folded_v2_siamese_matches_jax(net, interpret, use_pallas):
    jq, tq, cfg, x = net
    w1, w2 = JQ.apply_folded_v2_siamese(jq, cfg, jnp.asarray(x),
                                        use_pallas=use_pallas)
    g1, g2 = TQ.apply_folded_v2_siamese(tq, cfg, torch.from_numpy(x),
                                        use_pallas=use_pallas)
    for g, w in ((g1, w1), (g2, w2)):
        assert _rel(g.numpy(), w) < 0.02, _rel(g.numpy(), w)
    ij, ji = serving.decode_occ(g1, g2)
    s1, s2 = (1.0 / (1.0 + np.exp(-np.asarray(w, np.float64)))
              for w in (w1, w2))
    for p, dec in (((s1[:, 1] + s2[:, 0]) / 2, ij),
                   ((s1[:, 0] + s2[:, 1]) / 2, ji)):
        sure = np.abs(p - 0.5) > 1e-2
        np.testing.assert_array_equal(dec.numpy()[sure], p[sure] > 0.5)


# port wrapper -> the JAX kernel it stands for on the routes
PORT_TO_JAX = {
    'fused_bottleneck_i8v2_stage': 'fused_bottleneck_i8v2_hwnc_stage',
    'fused_bottleneck_i8v2_hwncp_stage': 'fused_bottleneck_i8v2_hwncp_stage',
    'fused_bottleneck_i8v2_down_s2': 'fused_bottleneck_down_s2_i8v2_hwnc',
    'fused_bottleneck_i8v2_identity': 'fused_bottleneck_i8v2_hwnc',
    'fused_bottleneck_down_i8v2_hwnc': 'fused_bottleneck_down_i8v2_hwnc',
    'fused_bottleneck_i8v2': 'fused_bottleneck_i8v2',
    'fused_bottleneck_down_i8v2': 'fused_bottleneck_down_i8v2',
}


@pytest.mark.parametrize('use_pallas,plain', [
    (True, 0), (('hwnc', 'down2', 'hwncp', 'dirpack'), 0),
    (('hwnc', 'down2', 'hwncs1d', 'hwncp'), 0),
    (('hwnc', 'down1', 'down2'), 0), (('hwnc', 'down1', 'down2', 'hwncs'), 0),
    (('hwnc', 'down1', 'down2', 'hwncs', 'hwncs1'), 0),
    (('hwnc', 'down2', 'hwncs1'), 1), (('hwncs',), 4),
    (('identity', 'down1'), 5), (('identity', 'down1', 'down2'), 3),
    (('identity', 'down1', 'stem2', 'qpool'), 5), (('down1',), 8)])
def test_v2_routes_like_jax(net, monkeypatch, use_pallas, plain):
    """Per feature set, each port wrapper is called as often as the JAX
    kernel it stands for (counted by monkeypatching both packages), and
    the plain chain runs the blocks no kernel covers (`plain` of the 9
    at layers (3, 2, 2, 2)). Also shown: 'hwncp' wins over 'hwncs1d',
    and without 'down1' layer1's projection runs plain."""
    jq, tq, cfg, x = net
    seen_t = {n: 0 for n in list(PORT_TO_JAX) + ['_plain_block_v2']}
    seen_j = {n: 0 for n in PORT_TO_JAX.values()}
    covered = [0]

    def spy_t(n, orig):
        def f(*a, **kw):
            seen_t[n] += 1
            return orig(*a, **kw)
        return f

    def spy_j(n, orig):
        def f(*a, **kw):
            seen_j[n] += 1
            # blocks the call covers: its identity run, and the
            # projection of a down=True or hwncp stage
            proj = kw.get('down') or n == 'fused_bottleneck_i8v2_hwncp_stage'
            covered[0] += kw.get('nblocks', 1) + int(proj)
            return orig(*a, **dict(kw, interpret=True))
        return f

    for n in PORT_TO_JAX:
        monkeypatch.setattr(TQ.bk, n, spy_t(n, getattr(TQ.bk, n)))
    monkeypatch.setattr(TQ, '_plain_block_v2',
                        spy_t('_plain_block_v2', TQ._plain_block_v2))
    for n in seen_j:
        monkeypatch.setattr(PB, n, spy_j(n, getattr(PB, n)))
    got = TQ.apply_folded_v2(tq, cfg, torch.from_numpy(x),
                             use_pallas=use_pallas)
    JQ.apply_folded_v2(jq, cfg, jnp.asarray(x), use_pallas=use_pallas)
    assert torch.isfinite(got).all()
    assert {n: seen_t[n] for n in PORT_TO_JAX} == {
        n: seen_j[j] for n, j in PORT_TO_JAX.items()}
    assert seen_t['_plain_block_v2'] == 9 - covered[0] == plain
    if use_pallas is not True and 'hwncp' in use_pallas:
        assert seen_t['fused_bottleneck_i8v2_hwncp_stage'] == 1
        assert seen_t['fused_bottleneck_i8v2_stage'] == 0
