"""The v2 (boundary-int8) model at compute_dtype=f32 against the JAX package
on the CPU: the plain versions of kernels 2-4 and 6-9 with f32 weights
against the Pallas kernels at f32 in interpret mode (int8 and f32
outputs), the q8 stem at f32 against JAX's `fused_stem(q8=True)`, the
folded v2 forward at f32 with each kernel feature set (directions 1 and
2 for the default set and its q8 stem; kernel calls counted against
JAX's), make_v2_predictor(compute_dtype=torch.float32) against JAX's,
the split K-major block weights of the v2 f32 tree (`wk`), and a model
on the host of the f32 GEMM's swizzled K-major stage: its loader, the
int8 raw tile and widen, and the TF32 split (csrc/bottleneck_f32.cu).

Bars (the v2 bars of tests/test_torch_variants.py): each block within
one int8 LSB on under 1% of outputs (f32 sums in another order move rare
round() ties), a chain of k blocks in one call within k LSB; the f32
output holds the int8 output's integers exactly; the q8 stem within one
LSB on under 1%; logits within 2% of max |logit|, decisions equal where
JAX is sure. Geometry: ResNet-50 widths at layers (3, 2, 1, 1), 64 x 64
inputs; blocks on 16 x 16 int8 planes (the JAX hwnc kernels take the
(H, W, N, C) view: inputs and outputs are transposed to compare)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from instaorder_tpu.eval import pipeline as JPL
from instaorder_tpu.models import folding as JF
from instaorder_tpu.models import quantize as JQ
from instaorder_tpu.models import resnet as jresnet
from instaorder_tpu.ops import pallas_blocks as PB

from test_torch_pipeline import scene
from test_torch_pipeline_factories import (KW, _calib, _nets, hold_factory,
                                           interpret,  # noqa: F401
                                           same_fold_and_scales)
from test_torch_variants import PORT_TO_JAX

from instaorder_tpu_torch import convert
from instaorder_tpu_torch.eval import pipeline as TPL
from instaorder_tpu_torch.models import folding as TF
from instaorder_tpu_torch.models import quantize as TQ
from instaorder_tpu_torch.ops import bottleneck_kernels as BK
from instaorder_tpu_torch.ops import gemm_layout
from instaorder_tpu_torch.ops import stem_kernels as SK
import torch_threads  # noqa: F401 (the suite's torch thread cap)

N, H = 2, 16
# kernel feature sets of the forward: the default, its q8 stem, and the
# hwncp, hwncs / hwncs1 and NHWC identity / down1 routes
FEATURE_SETS = [True, ('hwnc', 'down2', 'hwncs1d', 'dirpack', 'stem'),
                ('hwnc', 'down2', 'hwncp', 'dirpack'),
                ('hwnc', 'down1', 'down2', 'hwncs', 'hwncs1'),
                ('identity', 'down1')]


def _params(rng, cin, cm, cout, down):
    """tests/test_torch_bottleneck.py's block, f32: about half of the
    outputs inside 1..126 for int8 inputs."""
    w = lambda shape, s: (rng.randn(*shape) * s).astype(np.float32)
    p = [w((cin, cm), 0.6 / np.sqrt(cin) / 40), w((cm,), 0.2),
         w((3, 3, cm, cm), 1.2 / np.sqrt(9 * cm)), w((cm,), 0.2),
         w((cm, cout), 40.0 / np.sqrt(cm)), w((cout,), 5.0)]
    if down:
        p += [w((cin, cout), 1.0 / np.sqrt(cin)), w((cout,), 5.0)]
    return p


def _hwnc(x):
    return jnp.asarray(np.transpose(x, (1, 2, 0, 3)))


def _nhwc(y):
    return np.transpose(np.asarray(y, np.float32), (2, 0, 1, 3))


def _block_case(kind, rng):
    """(port call, JAX call, blocks chained) for one v2 wrapper on an
    int8 x, f32 weights: each call takes (x, out_int8)."""
    x_c, cout, down = {'identity': (64, 64, False), 'i8v2': (64, 64, False),
                       'down_s2': (64, 128, True),
                       'down1_hwnc': (64, 128, True),
                       'down_i8v2': (64, 128, True)}.get(kind, (32, 64, None))
    if down is not None:
        p = _params(rng, x_c, 16, cout, down)
        tp = [torch.from_numpy(a) for a in p]
        jp = [jnp.asarray(a) for a in p]
        r = 0.37
        port, jfn, view = {
            'identity': (lambda x, o: BK.fused_bottleneck_i8v2_identity(
                x, *tp, r, out_int8=o), lambda x, o: PB.fused_bottleneck_i8v2_hwnc(
                x, *jp, r, interpret=True, out_int8=o), True),
            'i8v2': (lambda x, o: BK.fused_bottleneck_i8v2(
                x, *tp, r, out_int8=o), lambda x, o: PB.fused_bottleneck_i8v2(
                x, *jp, r, interpret=True, out_int8=o), False),
            'down_s2': (lambda x, o: BK.fused_bottleneck_i8v2_down_s2(
                x, *tp, out_int8=o),
                lambda x, o: PB.fused_bottleneck_down_s2_i8v2_hwnc(
                x, *jp, interpret=True, out_int8=o), True),
            'down1_hwnc': (lambda x, o: BK.fused_bottleneck_down_i8v2_hwnc(
                x, *tp, out_int8=o),
                lambda x, o: PB.fused_bottleneck_down_i8v2_hwnc(
                x, *jp, interpret=True, out_int8=o), True),
            'down_i8v2': (lambda x, o: BK.fused_bottleneck_down_i8v2(
                x, *tp, out_int8=o),
                lambda x, o: PB.fused_bottleneck_down_i8v2(
                x, *jp, interpret=True, out_int8=o), False),
        }[kind]
        return x_c, port, jfn, view, 1
    # the stages: layer1 (projection + 2 identity blocks, kernels 2 and
    # 6) or an identity run of 2 blocks (kernel 2's down=False mode)
    run = kind == 'run'
    if run:
        x_c = 64
    dn = None if run else _params(rng, 32, 16, 64, True)
    blocks = [_params(rng, 64, 16, 64, False) for _ in range(2)]
    rs = [0.4, 0.6]
    tb = [[torch.from_numpy(a) for a in b] for b in blocks]
    flat = ([] if run else [jnp.asarray(a) for a in dn]) + [
        jnp.asarray(a) for b in blocks for a in b]
    td = None if run else [torch.from_numpy(a) for a in dn]
    jr = jnp.asarray(rs, jnp.float32)
    if kind == 'hwncp':
        port = lambda x, o: BK.fused_bottleneck_i8v2_hwncp_stage(
            x, td, tb, rs, out_int8=o)
        jfn = lambda x, o: PB.fused_bottleneck_i8v2_hwncp_stage(
            x, *flat, jr, nblocks=2, interpret=True, out_int8=o)
    else:
        port = lambda x, o: BK.fused_bottleneck_i8v2_stage(
            x, td, tb, rs, out_int8=o)
        jfn = lambda x, o: PB.fused_bottleneck_i8v2_hwnc_stage(
            x, *flat, jr, nblocks=2, down=not run, staging='act',
            out_int8=o, interpret=True)
    return x_c, port, jfn, True, 2 if run else 3


def _close(got, want, bar):
    got = got.float().numpy().astype(np.float64)
    d = np.abs(got - np.asarray(want, np.float64))
    assert d.max() <= bar, d.max()
    assert (d > 0).mean() < 0.01, (d > 0).mean()
    inner = ((want > 0) & (want < 127)).mean()
    assert inner > 0.2, f'degenerate test data: {inner:.2f} unclipped'


@pytest.mark.parametrize('kind', ['identity', 'down_s2', 'stage', 'run',
                                  'hwncp', 'down1_hwnc', 'i8v2', 'down_i8v2'])
def test_v2_f32_block_plain_matches_pallas(kind):
    """Kernels 4, 3, 2, 2', 6, 7, 8 and 9 with f32 weights: the port's
    plain version against the Pallas kernel at f32, int8 out and f32
    out. The f32 output holds exactly the int8 output's integers, and an
    f32 x holding the same integers gives the same output."""
    rng = np.random.RandomState(['identity', 'down_s2', 'stage', 'run',
                                 'hwncp', 'down1_hwnc', 'i8v2',
                                 'down_i8v2'].index(kind) + 40)
    c, port, jfn, view, k = _block_case(kind, rng)
    x = rng.randint(0, 128, (N, H, H, c)).astype(np.int8)
    xt = torch.from_numpy(x)
    outs = {}
    for o in (True, False):
        jx = _hwnc(x) if view else jnp.asarray(x)
        want = jfn(jx, o)
        want = _nhwc(want) if view else np.asarray(want, np.float32)
        got = port(xt, o)
        assert got.dtype == (torch.int8 if o else torch.float32)
        _close(got, want, k)
        outs[o] = got
    assert torch.equal(outs[False], outs[True].float())
    assert torch.equal(port(xt.float(), True), outs[True])


@pytest.mark.parametrize('cout', [64, 128])
def test_v2_f32_q8_stem_plain_matches_pallas(cout):
    """fused_stem(q8=True) at f32 (JAX's `_stem_v2` at f32 compute, the
    double-width stem at Cout 128): the plain version against the Pallas
    kernel, within one LSB on under 1% of outputs."""
    rng = np.random.RandomState(cout)
    x = rng.randn(N, 64, 64, 5).astype(np.float32)
    w = (rng.randn(7, 7, 5, cout) * 30 / np.sqrt(245)).astype(np.float32)
    b = (rng.randn(cout) * 3).astype(np.float32)
    want = np.asarray(PB.fused_stem(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(b), q8=True, interpret=True))
    got = SK.fused_stem(*(torch.from_numpy(a) for a in (x, w, b)), q8=True)
    assert got.dtype == torch.int8 and got.shape == want.shape
    d = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() < 0.01, (d.max(), (d > 0).mean())
    assert ((want > 0) & (want < 127)).mean() > 0.2


# ---------------------------------------------------------------------------
# the folded v2 forward at f32
# ---------------------------------------------------------------------------


@pytest.fixture(scope='module')
def net():
    """The v2 net quantized at f32 in JAX (jitted init and fold), the
    same tree in torch, the config and a 64 x 64 input batch."""
    box = {}

    def init(k):
        p, s, box['cfg'] = jresnet.init(k, arch='resnet50', in_channels=5,
                                        num_classes=2,
                                        layers_override=(3, 2, 1, 1))
        return JF.fold_resnet(p, s, box['cfg'])
    folded = jax.device_get(jax.jit(init)(jax.random.PRNGKey(4)))
    cfg = box['cfg']
    x = np.random.RandomState(4).randn(N, 64, 64, 5).astype(np.float32)
    scales = JQ.calibrate_folded_resnet(folded, cfg, [x])
    qv2 = jax.device_get(JQ.quantize_folded_v2(folded, cfg, scales,
                                               compute_dtype=jnp.float32))
    return qv2, convert.to_torch(qv2), cfg, x


@pytest.fixture
def calls(monkeypatch):
    """Every v2 kernel call of both packages counted by name, JAX's in
    interpret mode; the port's stem kernel counted as 'fused_stem'."""
    seen = {'jax': {}, 'port': {}}

    def spy(side, name, orig, **extra):
        def f(*a, **kw):
            seen[side][name] = seen[side].get(name, 0) + 1
            return orig(*a, **dict(kw, **extra))
        return f

    for n, j in PORT_TO_JAX.items():
        monkeypatch.setattr(TQ.bk, n, spy('port', j, getattr(TQ.bk, n)))
        monkeypatch.setattr(PB, j, spy('jax', j, getattr(PB, j),
                                       interpret=True))
    monkeypatch.setattr(TQ, 'fused_stem', spy('port', 'fused_stem',
                                              TQ.fused_stem))
    monkeypatch.setattr(PB, 'fused_stem', spy('jax', 'fused_stem',
                                              PB.fused_stem, interpret=True))
    return seen


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-6)


@pytest.mark.parametrize('use_pallas,directions', [
    *((f, 1) for f in FEATURE_SETS), (FEATURE_SETS[0], 2),
    (FEATURE_SETS[1], 2)])
def test_v2_f32_forward_matches_jax(net, calls, use_pallas, directions):
    """apply_folded_v2[_siamese] of the model quantized at f32 against
    JAX's at compute_dtype=jnp.float32: logits within 2% of max |logit|,
    every kernel called as often as JAX's."""
    jq, tq, cfg, x = net
    assert tq['layer1'][0]['conv1']['w'].dtype == torch.float32
    if directions == 1:
        want = (JQ.apply_folded_v2(jq, cfg, jnp.asarray(x),
                                   use_pallas=use_pallas),)
        got = (TQ.apply_folded_v2(tq, cfg, torch.from_numpy(x),
                                  use_pallas=use_pallas),)
    else:
        want = JQ.apply_folded_v2_siamese(jq, cfg, jnp.asarray(x),
                                          use_pallas=use_pallas)
        got = TQ.apply_folded_v2_siamese(tq, cfg, torch.from_numpy(x),
                                         use_pallas=use_pallas)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (N, 2)
        assert _rel(g.numpy(), w) < 0.02, _rel(g.numpy(), w)
        assert float(np.abs(np.asarray(w)).max()) > 1e-3
    assert calls['port'] == calls['jax'] and calls['port'], calls
    stem = use_pallas is not True and 'stem' in use_pallas
    assert calls['port'].get('fused_stem', 0) == int(stem)


# ---------------------------------------------------------------------------
# make_v2_predictor(compute_dtype=torch.float32)
# ---------------------------------------------------------------------------


def test_v2_f32_predictor_matches_jax(interpret, monkeypatch):
    """The dual-head net with the default set and the q8 stem, directions
    2: the batch at the prep bar, the logits on JAX's batch within 2%,
    the matrices equal where JAX is sure."""
    method = 'InstaOrderNet_od'
    use_pallas = FEATURE_SETS[1]
    j, t = _nets(method)
    image, masks, bboxes = scene(29, n=5)
    calib = _calib(image, masks, bboxes)
    same_fold_and_scales(monkeypatch, j, t, calib)
    jp = JPL.make_v2_predictor(*j[:3], method, calib, use_pallas=use_pallas,
                               compute_dtype=jnp.float32, **KW)
    tp = TPL.make_v2_predictor(*t[:3], method, calib, use_pallas=use_pallas,
                               compute_dtype=torch.float32, device='cpu',
                               **KW)
    assert tp.params['layer1'][0]['conv1']['w'].dtype == torch.float32
    assert 'wk' not in tp.params['conv1']      # no kernel weights on the CPU
    hold_factory(jp, tp, image, masks, bboxes, bar=0.02, exact=False,
                 dual=True)


# ---------------------------------------------------------------------------
# the v2 f32 tree's split K-major block weights
# ---------------------------------------------------------------------------


@pytest.fixture(scope='module')
def q32(net):
    """The v2 model of `net` quantized at compute_dtype=f32, and the same
    tree with the f32 block kernel's weights (add_f32_block_weights)."""
    _j, q, cfg, _x = net
    return q, TF.add_f32_block_weights(convert.tree_to(q, 'cpu')), cfg


def test_add_f32_block_weights_v2(q32):
    """Every block of the v2 tree quantized at f32 gets `wk` = the split
    K-major [w1, w2, w3(, wd)] of its f32 weights; the JAX-layout weights
    are the same tensors as before."""
    q, qw, _cfg = q32
    n = 0
    for li in range(4):
        for bp, orig in zip(qw[f'layer{li + 1}'], q[f'layer{li + 1}']):
            convs = [c for c in ('conv1', 'conv2', 'conv3', 'down')
                     if c in bp]
            assert len(bp['wk']) == len(convs)
            for c, wk in zip(convs, bp['wk']):
                assert bp[c]['w'] is orig[c]['w']
                assert bp[c]['w'].dtype == torch.float32
                assert torch.equal(wk,
                                   gemm_layout.split_kmajor_f32(bp[c]['w']))
            n += 1
            assert 'wk' not in orig
    assert n == sum(len(q[f'layer{li + 1}']) for li in range(4))


@pytest.mark.parametrize('use_pallas', [True, ('identity', 'down1')])
def test_v2_f32_forward_with_block_weights_unchanged(q32, use_pallas):
    """On the CPU the plain versions do not read `wk`: the v2 f32 forward
    of the tree carrying it equals the forward without it, at directions
    1 and 2."""
    q, qw, cfg = q32
    x = torch.as_tensor(np.random.RandomState(8).randn(2, 64, 64, 5),
                        dtype=torch.float32)
    for fwd in (TQ.apply_folded_v2, TQ.apply_folded_v2_siamese):
        got = fwd(qw, cfg, x, use_pallas=use_pallas)
        want = fwd(q, cfg, x, use_pallas=use_pallas)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# the f32 GEMM's swizzled K-major stage, modelled on the host
# ---------------------------------------------------------------------------

BM, BK_F32 = 128, gemm_layout.F32_K_STEP
RAW_ROW = 32                    # csrc/bottleneck_f32.cu kRawRow
A_F32, A_INT8 = 0, 1


def _swz(row, chunk):
    """conv_gemm.cuh swz128: byte offset of 16-byte chunk `chunk` of
    128-byte row `row` in a tile with the 128-byte swizzle."""
    return row * 128 + ((chunk ^ (row & 7)) << 4)


def _tf32(a):
    return gemm_layout.tf32(torch.from_numpy(np.ascontiguousarray(
        a, np.float32))).numpy()


def _stage(segs, m0, M, Ho, Wo, step):
    """The A rows [m0, m0 + 128) of K step `step` as csrc/bottleneck_f32.cu
    leaves them in the stage before the MMAs: each thread's 16-byte
    copies (an f32 segment: chunk q of rows tid / 8 + 32 i into A_hi at
    swz128(row, q); an int8 one: raw chunk q % 2 of row tid / 8 + 32 (q
    / 2) into the raw tile at 32 row + 16 (q % 2)), zero where the loader
    zero-fills; then each thread's `prepare` of the chunks it copied (an
    int8 chunk widened into A_hi chunks 4 (q % 2) .. + 3; an f32 chunk
    split, hi in place and lo into A_lo at the same offset). segs: [(x NHWC numpy, stride, ksize, kind)]. Returns
    (A_hi, A_lo) unswizzled, each (128, 32) f32 (A_lo None where the
    step takes no lo), and the count of writes to each 16-byte chunk of
    A_hi."""
    a_hi = np.full(BM * 128, 0xAB, np.uint8)
    a_lo = np.full(BM * 128, 0xAB, np.uint8)
    raw = np.full(BM * RAW_ROW, 0xCD, np.uint8)
    writes = np.zeros((BM, 8), np.int32)
    t = gemm_layout.check_k_steps([k * k * x.shape[-1]
                                   for x, _s, k, _kd in segs], step=BK_F32)
    sg = 0 if step < t[0] else 1
    x, stride, ks, kind = segs[sg]
    j = step - (t[0] if sg else 0)
    i8 = kind == A_INT8
    assert i8 == (x.dtype == np.int8)
    es, K, C = x.itemsize, ks * ks * x.shape[-1], x.shape[-1]
    pad = 1 if ks == 3 else 0
    copied = {}
    for tid in range(256):
        q = tid & 7
        for i in ([q >> 1] if i8 else range(4)):
            r = (tid >> 3) + 32 * i
            k = (16 * (q & 1) if i8 else 4 * q) + BK_F32 * j
            m = m0 + r
            n, rem = divmod(m, Ho * Wo)
            ho, wo = divmod(rem, Wo)
            tap, c = divmod(k, C)
            hi = ho * stride - pad + tap // ks
            wi = wo * stride - pad + tap % ks
            ok = (m < M and k < K and 0 <= hi < x.shape[1]
                  and 0 <= wi < x.shape[2])
            src = np.frombuffer(x[n, hi, wi, c:c + 16 // es].tobytes() if ok
                                else bytes(16), np.uint8)
            if i8:
                d = r * RAW_ROW + 16 * (q & 1)
                raw[d:d + 16] = src
            else:
                d = _swz(r, q)
                a_hi[d:d + 16] = src
                writes[r, q] += 1
            copied.setdefault(tid, []).append((r, q))
    for tid, chunks in copied.items():      # prepare: its own copies only
        for r, q in chunks:
            if i8:
                d = r * RAW_ROW + 16 * (q & 1)
                v = raw[d:d + 16].view(np.int8).astype(np.float32)
                for e in range(4):
                    o = _swz(r, 4 * (q & 1) + e)
                    a_hi[o:o + 16] = v[4 * e:4 * e + 4].view(np.uint8)
                    writes[r, 4 * (q & 1) + e] += 1
            elif kind == A_F32:
                o = _swz(r, q)
                v = a_hi[o:o + 16].view(np.float32).copy()
                h = _tf32(v)
                a_hi[o:o + 16] = h.view(np.uint8)
                a_lo[o:o + 16] = _tf32(v - h).view(np.uint8)

    def unswizzle(tile):
        f = np.zeros((BM, BK_F32), np.float32)
        for r in range(BM):
            for c in range(8):
                f[r, 4 * c:4 * c + 4] = tile[_swz(r, c):_swz(r, c) + 16].view(
                    np.float32)
        return f
    return (unswizzle(a_hi), unswizzle(a_lo) if kind == A_F32 else None,
            writes)


def _im2col(x, stride, ks, M, m0, Ho, Wo):
    """Rows [m0, m0 + 128) of the im2col view (zero past M), f32."""
    pad = 1 if ks == 3 else 0
    xp = np.pad(x.astype(np.float32), ((0, 0), (pad, pad), (pad, pad),
                                       (0, 0)))
    cols = np.concatenate([xp[:, dy:dy + stride * Ho:stride,
                              dx:dx + stride * Wo:stride, :]
                           for dy in range(ks) for dx in range(ks)], -1)
    cols = cols.reshape(-1, cols.shape[-1])
    out = np.zeros((BM, cols.shape[-1]), np.float32)
    rows = cols[m0:min(M, m0 + BM)]
    out[:len(rows)] = rows
    return out


def _check_step(got, want):
    """A step's (A_hi, A_lo, writes) against the im2col values `want`:
    every A_hi chunk written once; int8 values land as they are, f32
    ones as hi = tf32(v), lo = tf32(v - hi)."""
    hi, lo, writes = got
    assert (writes == 1).all()
    if lo is None:
        np.testing.assert_array_equal(hi, want)
    else:
        np.testing.assert_array_equal(hi, _tf32(want))
        np.testing.assert_array_equal(lo, _tf32(want - hi))
        assert (np.abs(hi.astype(np.float64) + lo - want)
                <= 2.0 ** -22 * np.abs(want)).all()


@pytest.mark.parametrize('n,hw,cm,cin,stride,m0,kind', [
    (2, 9, 64, 96, 2, 0, A_INT8),     # K-packed, int8 x at stride 2: 3 steps
    (3, 7, 128, 64, 1, 128, A_INT8),  # the second row tile, M = 147: ragged
    (1, 5, 64, 256, 1, 0, A_INT8),    # M = 25 < 128
    (2, 9, 64, 96, 2, 0, A_F32)],     # x held in f32: split, lo = 0
    ids=['2-9-64-96-2-0', '3-7-128-64-1-128', '1-5-64-256-1-0',
         '2-9-64-96-2-0-f32x'])
def test_f32_ring_kpacked_int8_second_segment(n, hw, cm, cin, stride, m0,
                                              kind):
    """The K-packed projection [h2 | x_s] with a v2 x (int8, or f32
    holding the integers): every K step of the ring (f32 h2 steps split
    into hi and lo, then x's steps, 32 raw bytes widened, or f32 split
    with lo = 0) holds the im2col rows' values, each A chunk written
    once; the K-packed rule counts both segments in 32-element steps,
    and rows past M are zero."""
    rng = np.random.RandomState(n + hw + cin)
    ho = (hw - 1) // stride + 1
    M = n * ho * ho
    h2 = rng.randn(n, ho, ho, cm).astype(np.float32)
    x = rng.randint(0, 128, (n, hw, hw, cin)).astype(np.int8)
    if kind == A_F32:
        x = x.astype(np.float32)
    segs = [(h2, 1, 1, A_F32), (x, stride, 1, kind)]
    steps = gemm_layout.check_k_steps([cm, cin], step=BK_F32)
    assert steps == [cm // 32, cin // 32]
    want = np.concatenate([_im2col(h2, 1, 1, M, m0, ho, ho),
                           _im2col(x, stride, 1, M, m0, ho, ho)], -1)
    for s in range(sum(steps)):
        got = _stage(segs, m0, M, ho, ho, s)
        x_step = s >= steps[0]
        assert (got[1] is None) == (x_step and kind == A_INT8)
        _check_step(got, want[:, 32 * s:32 * s + 32])
        if x_step and kind == A_F32:
            assert not got[1].any()     # integers: hi holds them, lo = 0
    assert not want[M - m0:].any()


@pytest.mark.parametrize('c,ks,stride', [(64, 1, 1), (256, 1, 1),
                                         (32, 3, 2), (64, 3, 1)])
def test_f32_ring_int8_conv_and_3x3_steps(c, ks, stride):
    """conv1 on an int8 x (one segment, 32 raw bytes a step, widened) and,
    for the model's f32 scratch, the 3x3 at the stride-2 edges (split
    into hi and lo): each step's A rows equal the im2col view, the halo
    zero."""
    rng = np.random.RandomState(c + ks)
    n, hw = 2, 9
    ho = (hw - 1) // stride + 1
    M = n * ho * ho
    x = (rng.randint(-128, 128, (n, hw, hw, c)).astype(np.int8) if ks == 1
         else rng.randn(n, hw, hw, c).astype(np.float32))
    kind = A_INT8 if ks == 1 else A_F32
    want = _im2col(x, stride, ks, M, 0, ho, ho)
    for s in range(ks * ks * c // 32):
        _check_step(_stage([(x, stride, ks, kind)], 0, M, ho, ho, s),
                    want[:, 32 * s:32 * s + 32])


def test_f32_ring_int8_widen_stays_in_one_warp():
    """The int8 loader's map: each (row, raw chunk) of a K step is copied
    once, by a thread that widens it itself (its own cp.async, complete
    after its wait: no barrier before the widen) into the row's f32
    chunks 4 c .. 4 c + 3, and a row's two raw chunks (its 32 bytes) go
    to two adjacent lanes of one warp; over the 256 threads every f32
    chunk of the 128 x 32 A_hi tile is written once, and the swizzle
    keeps a row's 8 chunks in 8 distinct 16-byte slots of its 128
    bytes."""
    seen = np.zeros((BM, 2), np.int32)
    widened = np.zeros((BM, 8), np.int32)
    by = np.zeros((BM, 2), np.int32)
    for tid in range(256):
        q = tid & 7
        row, chunk = (tid >> 3) + 32 * (q >> 1), q & 1
        seen[row, chunk] += 1
        by[row, chunk] = tid
        for e in range(4):
            widened[row, 4 * chunk + e] += 1
    assert (seen == 1).all() and (widened == 1).all()
    assert (by[:, 0] // 32 == by[:, 1] // 32).all()
    assert (by[:, 1] - by[:, 0] == 1).all()
    for row in range(BM):
        slots = {_swz(row, c) for c in range(8)}
        assert slots == {row * 128 + 16 * c for c in range(8)}
