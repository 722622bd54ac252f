"""Pair sharding: the port's OrderPredictor and its factories with
mesh=['cpu'] * 8 against the port's unsharded predictor and the JAX
package's with mesh=make_mesh(8) (tests/test_eval_pipeline.py's
test_pair_sharded_predictor_matches_single), on the CPU.

Against the unsharded port predictor: the same logits and matrices (each
row of an eval forward is computed on its own). Against JAX's sharded
predictor: test_torch_pipeline_factories.hold_factory's bars on JAX's
prepped batch (f32 and int8c logits within 1e-5 of max |logit| and the
matrices equal; v2 logits within 2%, the matrices equal where JAX is
sure), JAX's v2 kernels in interpret mode, its int8c route the XLA
oracle, on JAX's fold and calibration scales. A batch that does not
divide by the mesh size raises, as JAX's shard_map does.
"""

import numpy as np
import pytest
import torch

from instaorder_tpu.eval import pipeline as JPL
from instaorder_tpu.models import resnet as jresnet
from instaorder_tpu.parallel import make_mesh

from test_torch_pipeline import _flat, scene
from test_torch_pipeline_factories import (KW, _calib, _nets, hold_factory,
                                           interpret,  # noqa: F401
                                           same_fold_and_scales)

from instaorder_tpu_torch.eval import pipeline as TPL
from instaorder_tpu_torch.models import resnet as tresnet
import torch_threads

MESH = ['cpu'] * 8
METHOD = 'InstaOrderNet_o'
# (kind, logit bar, matrices exact)
KINDS = [('resnet', 1e-5, True), ('folded', 1e-5, True),
         ('int8', 1e-5, True), ('v2', 0.02, False)]


def jax_predictor(kind, j, calib, mesh):
    """JAX's predictor of `kind` with mesh=`mesh`."""
    kw = dict(KW, mesh=mesh)
    if kind == 'resnet':
        return JPL.OrderPredictor(jresnet.apply, j[2], j[0], j[1], METHOD,
                                  **kw)
    if kind == 'folded':
        return JPL.make_folded_predictor(*j[:3], METHOD, **kw)
    if kind == 'int8':
        return JPL.make_int8_predictor(*j[:3], METHOD, calib,
                                       use_pallas=False, **kw)
    return JPL.make_v2_predictor(*j[:3], METHOD, calib, **kw)


def port_predictor(kind, t, calib, mesh=None):
    """The port's predictor of `kind` on the CPU with mesh=`mesh`."""
    kw = dict(KW, mesh=mesh, device='cpu')
    if kind == 'resnet':
        return TPL.OrderPredictor(tresnet.apply, t[2], t[0], t[1], METHOD,
                                  **kw)
    if kind == 'folded':
        return TPL.make_folded_predictor(*t[:3], METHOD, **kw)
    if kind == 'int8':
        return TPL.make_int8_predictor(*t[:3], METHOD, calib, **kw)
    return TPL.make_v2_predictor(*t[:3], METHOD, calib, **kw)


@pytest.mark.parametrize('kind,bar,exact', KINDS, ids=[k[0] for k in KINDS])
def test_pair_sharded_predictor(kind, bar, exact, interpret, monkeypatch):
    j, t = _nets(METHOD)
    image, masks, bboxes = scene(25, n=5)       # 10 pairs, bucket 16
    calib = _calib(image, masks, bboxes)
    if kind in ('int8', 'v2'):
        same_fold_and_scales(monkeypatch, j, t, calib)
    jp = jax_predictor(kind, j, calib, make_mesh(8))
    tp, single = port_predictor(kind, t, calib, MESH), \
        port_predictor(kind, t, calib)
    assert tp.mesh == [torch.device('cpu')] * 8 and single.mesh is None
    # the port's sharded predictor against its unsharded one, at
    # PyTorch's default thread count: on an 8-core CPU the logits are
    # equal bit for bit at 2 and 8 intra-op threads and differ by up to
    # 2.0e-5 (2.9e-5 relative) at 1 and 4, where the f32 convolution's
    # sums follow the batch (16 rows unsharded, 2 a shard)
    with torch_threads.default():
        _, v1, a1, a2, _ = tp.pair_outputs(image, masks, bboxes)
        _, v2, b1, b2, _ = single.pair_outputs(image, masks, bboxes)
        occ = (tp.infer_occ_order(image, masks, bboxes),
               single.infer_occ_order(image, masks, bboxes))
    assert torch.equal(v1, v2)
    for g, w in zip(_flat(a1) + _flat(a2), _flat(b1) + _flat(b2)):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(*occ)
    # ... and against JAX's sharded one
    hold_factory(jp, tp, image, masks, bboxes, bar=bar, exact=exact,
                 dual=False, e2e=kind != 'int8')
    # a bucket of 16 pairs (the siamese forward's batch; 32 rows for two
    # direction passes) does not divide over 3 devices
    bad = port_predictor(kind, t, calib, ['cpu'] * 3)
    with pytest.raises(ValueError, match='divide'):
        bad.infer_occ_order(image, masks, bboxes)
    # to() gives the unsharded predictor
    assert tp.to('cpu').mesh is None
