"""The bf16 (folded) path's remaining kernel features against the JAX
package on the CPU: the plain versions of kernels 11 (`stage`), 12
(`sstage`) and 14 (`hwnc`) against the Pallas kernels in interpret mode,
the routing of each feature set, and the folded forward with each.

Bars: f32 outputs and logits within 1e-5 of max |want| (the
tests/test_goldens.py bar: f32 sums in another order); bf16 outputs
within 1e-2 of max |want| (a moved bf16 rounding moves the next stage).
Blocks at H = W = 8 (the JAX hwnc kernel takes the (H, W, N, C) view;
inputs and outputs are transposed to compare); the net is ResNet-50
widths at layers (3, 2, 2, 2), 64x64 inputs."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from instaorder_tpu.core.nn import tree_cast as j_tree_cast
from instaorder_tpu.models import folding as JF
from instaorder_tpu.models import resnet as jresnet
from instaorder_tpu.ops import pallas_blocks as PB

from instaorder_tpu_torch import convert
from instaorder_tpu_torch.core.nn import tree_cast
from instaorder_tpu_torch.models import folding as TF
from instaorder_tpu_torch.ops import bottleneck_bf16_kernels as B16
import torch_threads  # noqa: F401 (the suite's torch thread cap)

DT = {'f32': (jnp.float32, torch.float32),
      'bf16': (jnp.bfloat16, torch.bfloat16)}
JAX_KERNELS = ('fused_bottleneck', 'fused_bottleneck_down',
               'fused_bottleneck_stage', 'fused_bottleneck_stage_stream',
               'fused_bottleneck_hwnc', 'fused_stem')
FEATURE_SETS = [('hwnc',), ('stage',), ('sstage',), ('stage', 'hwnc'),
                ('stage', 'sstage', 'down1', 'stem')]


def _block(rng, cin=128, cm=32):
    """tests/test_pallas_blocks.py make_block's scales."""
    return [rng.randn(cin, cm) * 0.05, rng.randn(cm) * 0.1,
            rng.randn(3, 3, cm, cm) * 0.05, rng.randn(cm) * 0.1,
            rng.randn(cm, cin) * 0.05, rng.randn(cin) * 0.1]


def _both(arrs, dt):
    """Activations and weights in the compute dtype, biases (odd
    positions of a block) f32 for the port's kernels."""
    jdt, tdt = DT[dt]
    return ([jnp.asarray(np.asarray(a, np.float32), jdt) for a in arrs],
            [torch.from_numpy(np.asarray(a, np.float32)).to(
                torch.float32 if i % 2 else tdt) for i, a in enumerate(arrs)])


def _close(got, want, dt):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    bar = 1e-5 if dt == 'f32' else 1e-2
    assert np.abs(got - want).max() <= bar * scale, \
        (np.abs(got - want).max(), scale)
    assert np.count_nonzero(want) > 0.05 * want.size, 'degenerate data'


def _stage_inputs(dt, k, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, 8, 8, 128)
    blocks = [_both(_block(rng), dt) for _ in range(k)]
    (jx,), _ = _both([x], dt)
    tx = torch.from_numpy(x.astype(np.float32)).to(DT[dt][1])
    return jx, tx, [b[0] for b in blocks], [b[1] for b in blocks]


@pytest.mark.parametrize('dt', ['f32', 'bf16'])
@pytest.mark.parametrize('stream', [False, True])
def test_stage_plain_matches_pallas(dt, stream):
    """Kernels 11 and 12: three stacked identity blocks (the JAX kernels
    take the weights stacked on a leading block axis)."""
    jx, tx, jb, tb = _stage_inputs(dt, 3, 7 + stream)
    stacked = [jnp.stack([b[i] for b in jb]) for i in range(6)]
    jfn = PB.fused_bottleneck_stage_stream if stream else \
        PB.fused_bottleneck_stage
    want = jfn(jx, *stacked, interpret=True)
    tfn = B16.fused_bottleneck_stage_stream if stream else \
        B16.fused_bottleneck_stage
    got = tfn(tx, tb)
    assert got.dtype == DT[dt][1]
    _close(got, want, dt)


@pytest.mark.parametrize('dt', ['f32', 'bf16'])
def test_hwnc_plain_matches_pallas(dt):
    """Kernel 14: the identity block on the (H, W, N, C) view."""
    jx, tx, jb, tb = _stage_inputs(dt, 1, 9)
    want = PB.fused_bottleneck_hwnc(jnp.transpose(jx, (1, 2, 0, 3)), *jb[0],
                                    interpret=True)
    got = B16.fused_bottleneck_hwnc(tx, *tb[0])
    _close(got, np.transpose(np.asarray(want, np.float32), (2, 0, 1, 3)), dt)
    np.testing.assert_array_equal(
        got.float().numpy(), B16.fused_bottleneck(tx, *tb[0]).float().numpy())


# ---------------------------------------------------------------------------
# the folded forward
# ---------------------------------------------------------------------------


@pytest.fixture(scope='module')
def net():
    params, stats, cfg = jresnet.init(
        jax.random.PRNGKey(1), arch='resnet50', in_channels=5,
        num_classes=2, layers_override=(3, 2, 2, 2))
    folded = jax.device_get(JF.fold_resnet(params, stats, cfg))
    x = np.random.RandomState(1).randn(3, 64, 64, 5).astype(np.float32)
    return folded, convert.to_torch(folded), cfg, x


@pytest.fixture
def interpret(monkeypatch):
    for n in JAX_KERNELS:
        orig = getattr(PB, n)
        monkeypatch.setattr(PB, n, (lambda o: lambda *a, **kw: o(
            *a, **dict(kw, interpret=True)))(orig))


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-6)
    return float(np.abs(got - want).max()) / scale


@pytest.mark.parametrize('use_pallas', FEATURE_SETS)
def test_apply_folded_matches_jax(net, interpret, use_pallas):
    folded, tf, cfg, x = net
    want = JF.apply_folded(folded, cfg, jnp.asarray(x), use_pallas=use_pallas)
    got = TF.apply_folded(tf, cfg, torch.from_numpy(x), use_pallas=use_pallas)
    assert _rel(got.numpy(), want) <= 1e-5, _rel(got.numpy(), want)
    assert float(np.abs(np.asarray(want)).max()) > 1e-3


@pytest.mark.parametrize('use_pallas', FEATURE_SETS[:3])
def test_apply_folded_siamese_matches_jax(net, interpret, use_pallas):
    folded, tf, cfg, x = net
    w1, w2 = JF.apply_folded_siamese(folded, cfg, jnp.asarray(x),
                                     use_pallas=use_pallas)
    g1, g2 = TF.apply_folded_siamese(tf, cfg, torch.from_numpy(x),
                                     use_pallas=use_pallas)
    for g, w in ((g1, w1), (g2, w2)):
        assert _rel(g.numpy(), w) <= 1e-5, _rel(g.numpy(), w)


def test_apply_folded_siamese_bf16_stage_matches_jax(net, interpret):
    """The parity profile's forward (bf16 tree and compute) with
    'sstage': within 2% of max |logit| (the bf16 bar of
    tests/test_torch_siamese.py)."""
    folded, tf, cfg, x = net
    w1, w2 = JF.apply_folded_siamese(j_tree_cast(folded, jnp.bfloat16), cfg,
                                     jnp.asarray(x), dtype=jnp.bfloat16,
                                     use_pallas=('sstage',))
    g1, g2 = TF.apply_folded_siamese(tree_cast(tf, torch.bfloat16), cfg,
                                     torch.from_numpy(x),
                                     dtype=torch.bfloat16,
                                     use_pallas=('sstage',))
    for g, w in ((g1, w1), (g2, w2)):
        assert _rel(g.numpy(), w) < 0.02, _rel(g.numpy(), w)


@pytest.mark.parametrize('use_pallas,plain', [
    (True, 6), (('hwnc',), 6), (('stage',), 6), (('sstage',), 6),
    (('stage', 'sstage'), 6), (('hwnc', 'stage', 'sstage'), 6),
    (('stage', 'down'), 3), (('stage', 'identity', 'down1'), 5)])
def test_bf16_routes_like_jax(net, monkeypatch, use_pallas, plain):
    """Per feature set, each port wrapper is called as often as the JAX
    kernel of the same name, and the plain chain runs `plain` of the 9
    blocks at layers (3, 2, 2, 2) (those with conv1 Cin > 512 and the
    projections without 'down'). Also shown: 'hwnc' wins over 'stage'
    and 'sstage', 'sstage' over 'stage', and a run of one block (layer2)
    goes to fused_bottleneck."""
    folded, tf, cfg, x = net
    names = ('fused_bottleneck', 'fused_bottleneck_down',
             'fused_bottleneck_stage', 'fused_bottleneck_stage_stream',
             'fused_bottleneck_hwnc')
    seen_t = {n: 0 for n in names + ('_plain_block',)}
    seen_j = {n: 0 for n in names}

    def spy(seen, n, orig, **extra):
        def f(*a, **kw):
            seen[n] += 1
            return orig(*a, **dict(kw, **extra))
        return f

    for n in names:
        monkeypatch.setattr(TF.bk16, n, spy(seen_t, n, getattr(TF.bk16, n)))
        monkeypatch.setattr(PB, n, spy(seen_j, n, getattr(PB, n),
                                       interpret=True))
    monkeypatch.setattr(TF, '_plain_block',
                        spy(seen_t, '_plain_block', TF._plain_block))
    got = TF.apply_folded(tf, cfg, torch.from_numpy(x), use_pallas=use_pallas)
    JF.apply_folded(folded, cfg, jnp.asarray(x), use_pallas=use_pallas)
    assert torch.isfinite(got).all()
    assert {n: seen_t[n] for n in names} == seen_j
    assert seen_t['_plain_block'] == plain
    feats = set(use_pallas) if use_pallas is not True else set()
    stages = (seen_t['fused_bottleneck_stage'],
              seen_t['fused_bottleneck_stage_stream'])
    if 'hwnc' in feats:
        assert seen_t['fused_bottleneck_hwnc'] == 3 and stages == (0, 0)
    elif 'sstage' in feats:
        assert stages == (0, 1) and seen_t['fused_bottleneck'] == 1
