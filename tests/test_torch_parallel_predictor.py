"""Pair sharding: the port's OrderPredictor and its factories with
mesh=['cpu'] * 8 against the port's unsharded predictor and the JAX
package's with mesh=make_mesh(8) (tests/test_eval_pipeline.py's
test_pair_sharded_predictor_matches_single), on the CPU.

Against the unsharded port predictor (hold_sharded), at the running
thread count: the sharded logits equal, bit for bit, those of the
unsharded predictor with its forward run on the mesh's chunks of its
batch; they lie no further from the unsharded logits than that
forward's own spread between the whole batch and the chunks, measured
at the same thread count; the matrices equal. The spread depends on the
thread count: on an 8-core CPU with MKL it is 0 at 2 and 8 intra-op
threads and up to ~3e-5 at 1 (first at layer4's 1x1 convolution, 512 ->
256 at 8^2, 32 rows against 4) and at 4 (only at the head's f32 matmul,
(32, 2048) @ (2048, 2) against (4, 2048) @ (2048, 2): MKL's sgemm sums K
in another order when M differs; the trunk's values are equal).
test_sharding_holds_at_each_thread_count runs that hold at 1, 2, 4 and
8 threads. Against JAX's sharded predictor: test_torch_pipeline_factories
.hold_factory's bars on JAX's prepped batch (f32 and int8c logits within
1e-5 of max |logit| and the matrices equal; v2 logits within 2%, the
matrices equal where JAX is sure), JAX's v2 kernels in interpret mode,
its int8c route the XLA oracle, on JAX's fold and calibration scales. A
batch that does not divide by the mesh size raises, as JAX's shard_map
does.
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


def chunked(pred, k):
    """A _sharded for the unsharded `pred`: its forward on k contiguous
    equal chunks of the batch, on its own trees and device, the outputs
    concatenated in order (a k-device mesh's arithmetic, without one)."""
    def run(fn, x):
        outs = [fn(pred.params, pred.stats, c)
                for c in x.split(x.shape[0] // k)]

        def gather(parts):
            if isinstance(parts[0], tuple):
                return tuple(gather(p) for p in zip(*parts))
            return torch.cat(parts)
        return gather(outs)
    return run


def hold_sharded(tp, single, image, masks, bboxes):
    """The sharded predictor tp against the unsharded one at the running
    thread count (the module docstring's bars). Returns the spread."""
    got = tp.pair_outputs(image, masks, bboxes)
    whole = single.pair_outputs(image, masks, bboxes)
    single._sharded = chunked(single, len(tp.mesh))
    try:
        chunks = single.pair_outputs(image, masks, bboxes)
    finally:
        del single._sharded
    assert torch.equal(got[1], whole[1])
    logits = lambda out: _flat(out[2]) + _flat(out[3])  # noqa: E731
    spread = max(float(np.abs(c - w).max())
                 for c, w in zip(logits(chunks), logits(whole)))
    for g, c, w in zip(logits(got), logits(chunks), logits(whole)):
        np.testing.assert_array_equal(g, c)
        assert np.abs(g - w).max() <= spread
    # infer_occ_order's matrices, from these outputs
    np.testing.assert_array_equal(tp._occ(*got), single._occ(*whole))
    return spread


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
    # the port's sharded predictor against its unsharded one ...
    hold_sharded(tp, single, image, masks, bboxes)
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


@pytest.mark.parametrize('threads', [1, 2, 4, 8])
def test_sharding_holds_at_each_thread_count(threads):
    """hold_sharded of every kind at `threads` intra-op threads (the
    port's own fold and calibration)."""
    _, t = _nets(METHOD)
    image, masks, bboxes = scene(25, n=5)
    calib = [torch.from_numpy(c) for c in _calib(image, masks, bboxes)]
    with torch_threads.at(threads):
        for kind, _, _ in KINDS:
            hold_sharded(port_predictor(kind, t, calib, MESH),
                         port_predictor(kind, t, calib), image, masks,
                         bboxes)
