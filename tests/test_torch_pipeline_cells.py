"""The predictor's remaining head x route cells against the JAX package's
same factory on the CPU (bars and helpers: test_torch_pipeline_factories
.py):

  * InstaOrderNet_d (the 3-class depth head) through make_folded_predictor
    at f32 (the 5-channel prep with f32 output, the f32 kernels
    `identity,down,stem`; logits 1e-5, matrices equal) and bf16
    (`identity,down,stem`; 2%, matrices equal where JAX is sure),
    make_int8_predictor (int8c; 1e-5, matrices equal, on JAX's fold and
    scales) and make_v2_predictor (2%, sure cells), each through
    infer_depth_order at directions 2 (the swapped direction's softmax
    averaged with its labels exchanged, decode_depth) and, for f32, at
    directions 1;
  * InstaOrderNet_od (the dual head) on the bf16 `stage`, `sstage` and
    `hwnc` sets (JAX's kernels in interpret mode; 2%, sure cells), on a
    net of layers (3, 2, 1, 1), whose identity runs these sets route (the
    other cells' layers (1, 1, 1, 1) have none): the port's kernel calls
    in one forward equal to those in JAX's traced program, and more
    than 0;
  * InstaOrderNet_od on int8c `hwnc,down,stem` against JAX's XLA int8
    oracle (the port's hwnc plain versions equal it bit for bit,
    tests/test_torch_int8c.py; 1e-5, matrices equal).
A depth decision is sure where JAX's top averaged class leads the next
by more than 1e-2.
"""

import jax.numpy as jnp
import pytest
import torch

from instaorder_tpu.eval import pipeline as JPL
from instaorder_tpu.models import resnet as jresnet
from instaorder_tpu.ops import pallas_blocks

from test_torch_pipeline import scene
from test_torch_train_step import one_torch_thread  # noqa: F401 (a fixture)
from test_torch_pipeline_factories import (KFEATS, KW, _calib, _nets,
                                           hold_factory, interpret,  # noqa
                                           same_fold_and_scales)

from instaorder_tpu_torch import convert
from instaorder_tpu_torch.eval import pipeline as TPL
from instaorder_tpu_torch.ops import bottleneck_bf16_kernels as B16
import torch_threads  # noqa: F401 (the suite's torch thread cap)

D = 'InstaOrderNet_d'
BF16_SETS = ('stage', 'sstage', 'hwnc')
# and the identity kernel, which takes a run of one under stage / sstage
BF16_KERNELS = ('fused_bottleneck_stage', 'fused_bottleneck_stage_stream',
                'fused_bottleneck_hwnc', 'fused_bottleneck')


@pytest.mark.parametrize('directions', [2, 1])
def test_depth_folded_f32_matches_jax(directions):
    j, t = _nets(D)
    kw = dict(KW, prep_impl='pallas5', directions=directions)
    jp = JPL.make_folded_predictor(*j[:3], D, prep_interpret=True, **kw)
    tp = TPL.make_folded_predictor(*t[:3], D, use_pallas=KFEATS,
                                   device='cpu', **kw)
    hold_factory(jp, tp, *scene(31, n=4), bar=1e-5, exact=True, dual=False)


def test_depth_folded_bf16_matches_jax(interpret):
    j, t = _nets(D)
    jp = JPL.make_folded_predictor(*j[:3], D, dtype=jnp.bfloat16,
                                   use_pallas=KFEATS, **KW)
    tp = TPL.make_folded_predictor(*t[:3], D, dtype=torch.bfloat16,
                                   use_pallas=KFEATS, device='cpu', **KW)
    hold_factory(jp, tp, *scene(32, n=4), bar=0.02, exact=False,
                 dual=False)


def test_depth_int8_matches_jax(monkeypatch):
    j, t = _nets(D)
    image, masks, bboxes = scene(33, n=4)
    calib = _calib(image, masks, bboxes)
    same_fold_and_scales(monkeypatch, j, t, calib)
    jp = JPL.make_int8_predictor(*j[:3], D, calib, use_pallas=False, **KW)
    tp = TPL.make_int8_predictor(*t[:3], D, calib, device='cpu', **KW)
    hold_factory(jp, tp, image, masks, bboxes, bar=1e-5, exact=True,
                 dual=False, e2e=False)


def test_depth_v2_matches_jax(interpret, monkeypatch):
    j, t = _nets(D)
    image, masks, bboxes = scene(34, n=4)
    calib = _calib(image, masks, bboxes)
    same_fold_and_scales(monkeypatch, j, t, calib)
    jp = JPL.make_v2_predictor(*j[:3], D, calib, **KW)
    tp = TPL.make_v2_predictor(*t[:3], D, calib, device='cpu', **KW)
    hold_factory(jp, tp, image, masks, bboxes, bar=0.02, exact=False,
                 dual=False)


_DEEP = {}


def deep_net():
    """The dual-head net (test_torch_pipeline.net's init) at layers (3, 2,
    1, 1): identity runs of 2 and 1 blocks. Its heads are not scaled:
    this depth already gives logits of ~0.5, where HEAD_GAIN's ~50 would
    saturate both directions' sigmoids and leave every averaged decision
    at 0.5."""
    if not _DEEP:
        box = {}

        def init(k):
            p, s, box['cfg'] = jresnet.init(
                k, arch='resnet50', in_channels=5, num_classes=[2, 3],
                layers_override=(3, 2, 1, 1))
            return p, s
        import jax
        p, s = jax.device_get(jax.jit(init)(jax.random.PRNGKey(1)))
        _DEEP.update(j=(p, s, box['cfg']),
                     t=(convert.to_torch(p), convert.to_torch(s),
                        box['cfg']))
    return _DEEP['j'], _DEEP['t']


@pytest.fixture
def counted_bf16(monkeypatch):
    """JAX's stage / sstage / hwnc and identity kernels in interpret mode;
    each package's calls of them counted."""
    calls = {'jax': 0, 'port': 0}

    def wrap(fn, who, **extra):
        def f(*a, **kw):
            calls[who] += 1
            return fn(*a, **dict(kw, **extra))
        return f
    for n in BF16_KERNELS:
        monkeypatch.setattr(pallas_blocks, n,
                            wrap(getattr(pallas_blocks, n), 'jax',
                                 interpret=True))
        monkeypatch.setattr(B16, n, wrap(getattr(B16, n), 'port'))
    return calls


@pytest.mark.parametrize('feature', BF16_SETS)
def test_dual_bf16_sets_match_jax(feature, counted_bf16):
    j, t = deep_net()
    jp = JPL.make_folded_predictor(*j, 'InstaOrderNet_od',
                                   dtype=jnp.bfloat16,
                                   use_pallas=(feature,), **KW)
    tp = TPL.make_folded_predictor(*t, 'InstaOrderNet_od',
                                   dtype=torch.bfloat16,
                                   use_pallas=(feature,), device='cpu', **KW)
    sc = scene(35, n=4)
    hold_factory(jp, tp, *sc, bar=0.02, exact=False, dual=True)
    # JAX counts its kernels once, when it traces the siamese program;
    # the port counts each forward's calls: one forward's
    counted_bf16['port'] = 0
    tp.pair_outputs(*sc)
    assert counted_bf16['port'] == counted_bf16['jax'] > 0, counted_bf16


def test_dual_int8c_hwnc_down_stem_matches_jax(monkeypatch):
    j, t = _nets('InstaOrderNet_od')
    image, masks, bboxes = scene(36, n=4)
    calib = _calib(image, masks, bboxes)
    same_fold_and_scales(monkeypatch, j, t, calib)
    jp = JPL.make_int8_predictor(*j[:3], 'InstaOrderNet_od', calib,
                                 use_pallas=False, **KW)
    tp = TPL.make_int8_predictor(*t[:3], 'InstaOrderNet_od', calib,
                                 use_pallas=('hwnc', 'down', 'stem'),
                                 device='cpu', **KW)
    hold_factory(jp, tp, image, masks, bboxes, bar=1e-5, exact=True,
                 dual=True, e2e=False)
