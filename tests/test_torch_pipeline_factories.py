"""The port's predictor factories against the JAX package's same factory
on the CPU: make_folded_predictor (f32 and bf16), make_v2_predictor and
make_int8_predictor, each for InstaOrderNet_o and the dual-head
InstaOrderNet_od, on the same params (made in JAX from a seed, converted)
and the same calibration batch. The f32 predictor runs the 5-channel
prep with f32 output (JAX's kernel in interpret mode), the others the
einsum prep (the 5-channel prep's bf16 mode is held in
tests/test_torch_pipeline_heads.py). The JAX kernels of the v2 and bf16
routes run in interpret mode with the same feature sets as the port.

Bars on the forward of the same prepped batch (JAX's, fed to both):
  f32     logits within 1e-5 of max |logit|, matrices equal;
  bf16    logits within 2% of max |logit| (tests/test_torch_siamese.py's
          bar: bf16 roundings move with the order of f32 sums);
  v2      logits within 2% of max |logit| (boundary round() ties);
  int8c   logits within 1e-5 of max |logit| (s32 sums are exact; only
          the f32 head reassociates), matrices equal.
The matrices of bf16 and v2 are equal wherever JAX's probability is more
than 1e-2 from 0.5 (for depth: wherever its top class leads the next by
more than 1e-2). The prep is held to the prep bar, and end to end (each
predictor on its own prep) the matrices are held as on the same batch,
except int8c's: there one flipped input LSB of a prep tie moves logits
by up to ~4% through the int8 roundings, so end to end the prep bar
holds the difference.

The quantized factories are fed JAX's BN fold and calibration scales
(`same_fold_and_scales`), each first held against the port's own."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from instaorder_tpu.eval import pipeline as JPL
from instaorder_tpu.models import quantize as JQ
from instaorder_tpu.models.folding import fold_resnet as j_fold
from instaorder_tpu.ops import pairs as JP
from instaorder_tpu.ops import pallas_blocks

from test_torch_pipeline import _batches, assert_logits_close, net, scene

from instaorder_tpu_torch import convert
from instaorder_tpu_torch.eval import pipeline as TPL
from instaorder_tpu_torch.models import quantize as TQ
from instaorder_tpu_torch.models.folding import fold_resnet as t_fold
import torch_threads  # noqa: F401 (the suite's torch thread cap)

KFEATS = ('identity', 'down', 'stem')
KERNELS = ('fused_bottleneck', 'fused_bottleneck_down', 'fused_stem',
           'fused_bottleneck_i8v2_hwnc', 'fused_bottleneck_i8v2_hwnc_stage',
           'fused_bottleneck_down_s2_i8v2_hwnc',
           'fused_bottleneck_down_i8v2_hwnc')
NUM_CLASSES = {'InstaOrderNet_o': 2, 'InstaOrderNet_od': [2, 3],
               'InstaOrderNet_d': 3}


@pytest.fixture
def interpret(monkeypatch):
    """The JAX kernels of these routes in interpret mode."""
    for n in KERNELS:
        orig = getattr(pallas_blocks, n)
        monkeypatch.setattr(pallas_blocks, n,
                            (lambda o: lambda *a, **kw: o(
                                *a, **dict(kw, interpret=True)))(orig))


def _calib(image, masks, bboxes):
    pidx, _ = JP.all_pair_indices(masks.shape[0])
    return [np.asarray(JP.build_pair_batch(
        jnp.asarray(image), jnp.asarray(masks), jnp.asarray(bboxes),
        jnp.asarray(pidx), out_size=64), np.float32)]


def same_fold_and_scales(monkeypatch, j, t, calib):
    """The port's BN fold equals JAX's to rtol 1e-6 (XLA's rsqrt and
    PyTorch's differ by an ulp) and its calibration of the folded net to
    rtol 1e-5 (f32 sums in another order; tests/test_torch_slice.py);
    the factory then quantizes JAX's folded tree with JAX's scales. An
    ulp of a weight or a scale can move a round() of the quantization,
    and the quantized paths' bars hold for the same inputs."""
    jfolded = jax.device_get(j_fold(*j))
    flat = lambda tree: [np.asarray(a, np.float32).ravel()
                         for a in jax.tree_util.tree_leaves(tree)]
    for g, w in zip(flat(convert.to_numpy(t_fold(*t))), flat(jfolded)):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)
    want = jax.device_get(JQ.calibrate_folded_resnet(jfolded, j[2], calib))
    got = TQ.calibrate_folded_resnet(convert.to_torch(jfolded), t[2],
                                     [torch.from_numpy(c) for c in calib])
    np.testing.assert_allclose(np.concatenate(flat(got)),
                               np.concatenate(flat(want)), rtol=1e-5)
    monkeypatch.setattr(TPL, 'fold_resnet',
                        lambda *a: convert.to_torch(jfolded))
    monkeypatch.setattr(TQ, 'calibrate_folded_resnet',
                        lambda *a: convert.to_torch(want))
    # JAX's factory calibrates the same folded tree again: reuse `want`
    monkeypatch.setattr(JQ, 'calibrate_folded_resnet', lambda *a: want)


def _depth_probs(d1, d2):
    """decode_depth's averaged softmax [closer, farther, equal] of the
    (i, j) direction (d2 None: directions=1)."""
    def sm(o):
        o = np.asarray(o, np.float64)
        e = np.exp(o - o.max(-1, keepdims=True))
        return e / e.sum(-1, keepdims=True)
    if d2 is None:
        return sm(d1)
    d1, d2 = sm(d1), sm(d2)
    return np.stack([(d1[:, 0] + d2[:, 1]) / 2, (d1[:, 1] + d2[:, 0]) / 2,
                     (d1[:, 2] + d2[:, 2]) / 2], axis=1)


def _probs(out1, out2, method):
    """JAX's occlusion (p_ij, p_ji) and depth softmax averages."""
    if method == 'InstaOrderNet_d':
        return {'depth': _depth_probs(out1, out2)}
    sig = lambda o: 1.0 / (1.0 + np.exp(-np.asarray(o, np.float64)))
    occ = lambda o: o[0] if isinstance(o, tuple) else o
    s1, s2 = sig(occ(out1)), sig(occ(out2))
    probs = {'occ': ((s1[:, 1] + s2[:, 0]) / 2, (s1[:, 0] + s2[:, 1]) / 2)}
    if isinstance(out1, tuple):
        probs['depth'] = _depth_probs(out1[1], out2[1])
    return probs


def _sure_cells(pidx, valid, probs, kind, margin=1e-2):
    """The matrix cells whose JAX decision is sure."""
    cells = []
    for k in np.flatnonzero(valid):
        i, j = pidx[k]
        if kind == 'occ':
            p_ij, p_ji = probs['occ'][0][k], probs['occ'][1][k]
            if abs(p_ij - 0.5) > margin:
                cells.append((i, j))
            if abs(p_ji - 0.5) > margin:
                cells.append((j, i))
        else:
            top = np.sort(probs['depth'][k])
            if top[-1] - top[-2] > margin:
                cells += [(i, j), (j, i)]
    return tuple(np.asarray(cells).T)


def _infer(p, method, image, masks, bboxes, dual):
    """[(matrix, kind)] of predictor p's infer_* method for its head."""
    args = (image, masks, bboxes)
    if method == 'InstaOrderNet_d':
        return [(p.infer_depth_order(*args), 'depth')]
    if not dual:
        return [(p.infer_occ_order(*args), 'occ')]
    return list(zip(p.infer_occ_depth_order(*args), ('occ', 'depth')))


def _matrices(want, tp, image, masks, bboxes, dual):
    """[(port matrix, JAX matrix, kind)] of the infer_* methods; `want`
    is _infer of the JAX predictor on the same scene."""
    got = _infer(tp, tp.method, image, masks, bboxes, dual)
    if len(got) == 2:
        args = (image, masks, bboxes)
        np.testing.assert_array_equal(tp.infer_occ_order(*args), got[0][0])
        np.testing.assert_array_equal(tp.infer_depth_order(*args), got[1][0])
    return [(g, w, kind) for (g, kind), (w, _) in zip(got, want)]


def _hold_matrices(mats, exact, pidx, valid, probs):
    for got, want, kind in mats:
        if exact:
            np.testing.assert_array_equal(got, want)
        else:
            cells = _sure_cells(pidx, valid, probs, kind)
            assert len(cells[0]) > 0
            np.testing.assert_array_equal(got[cells], want[cells])


def hold_factory(jp, tp, image, masks, bboxes, bar, exact, dual, e2e=True):
    """The prep at the prep bar; on JAX's batch the logits at `bar` and
    the matrices equal (`exact`) or equal where JAX is sure; end to end
    (each on its own prep; `e2e`) the matrices as on the same batch."""
    xj, xt, _ = _batches(jp, tp, image, masks, bboxes)
    np.testing.assert_array_equal(xt[..., :2], xj[..., :2])
    lsb = 0.03125 if tp.prep_dtype == torch.bfloat16 \
        else 1.0 / (255 * 0.224)
    d = np.abs(xt[..., 2:] - xj[..., 2:])
    assert d.max() <= lsb + 1e-6 and (d > 1e-5).mean() < 0.01, d.max()

    pidx, jvalid, j1, j2, _ = jp._pair_outputs(image, masks, bboxes)
    jvalid = np.asarray(jvalid)
    probs = _probs(j1, j2, tp.method)
    scale = np.abs(np.asarray(j1[0] if dual else j1)).max()
    assert scale > 0.1, 'degenerate test net'
    # JAX's matrices, computed once: both checks below hold the port's to
    # the same JAX predictor on the same scene
    want = _infer(jp, tp.method, image, masks, bboxes, dual)
    build = tp._build_batch
    tp._build_batch = lambda *a: (torch.from_numpy(xj).to(tp.prep_dtype),
                                  None)
    try:
        _, tvalid, t1, t2, _ = tp.pair_outputs(image, masks, bboxes)
        np.testing.assert_array_equal(tvalid.numpy(), jvalid)
        assert_logits_close(t1, j1, bar)
        assert_logits_close(t2, j2, bar)
        _hold_matrices(_matrices(want, tp, image, masks, bboxes, dual),
                       exact, pidx, jvalid, probs)
    finally:
        tp._build_batch = build
    if e2e:
        _hold_matrices(_matrices(want, tp, image, masks, bboxes, dual),
                       exact, pidx, jvalid, probs)


def _nets(method):
    jpar, jst, tpar, tst, cfg = net(NUM_CLASSES[method])
    return (jpar, jst, cfg), (tpar, tst, cfg)


KW = dict(patch_or_image='patch', input_size=64)


@pytest.mark.parametrize('method', ['InstaOrderNet_o', 'InstaOrderNet_od'])
def test_folded_f32_predictor_matches_jax(method):
    """The strict-parity predictor: f32 model, f32 5-channel prep (row
    1'', JAX's kernel in interpret mode)."""
    j, t = _nets(method)
    kw = dict(KW, prep_impl='pallas5')
    jp = JPL.make_folded_predictor(*j[:3], method, prep_interpret=True, **kw)
    tp = TPL.make_folded_predictor(*t[:3], method, device='cpu', **kw)
    assert tp.prep_dtype == torch.float32
    hold_factory(jp, tp, *scene(21, n=5), bar=1e-5, exact=True,
                 dual=method != 'InstaOrderNet_o')
