"""The port's f32 route (`--dtype f32`, the f32 predictor) against the JAX
package on the CPU: the f32 megastep at directions 1 and 2 with each
kernel feature set and its prep, kernel 5's f32-output mode, the f32
folded predictor with kernels, and the host-side layouts and the
method of the card's f32 GEMM (its K step, its split K-major weights,
its fragment tiles and a numpy model of its 3xTF32 sums; the f32 stem's
layout is held in tests/test_torch_stem_layout.py).

Geometry: ResNet-50 widths at layers (3, 2, 1, 1) (a layer1 identity run
of two blocks for `stage` / `sstage`), 2 scenes of 96 x 128 with 3
instances (6 pairs, 12 images at directions 2), 64 x 64 crops; weights
made in JAX from a seed, the head scaled so that decisions are sure.
JAX's Pallas kernels run in interpret mode.

Bars: the pair batch at the prep bar (masks exact, RGB within one uint8
LSB, 1 / (255 * 0.224) in f32, with under 1% of pixels more than 1e-5
apart: the two f32 normalisations differ by an ulp on most pixels, see
tests/test_torch_pipeline.py); the forward on the same batch within
1e-5 of max |logit| (f32 sums in another order), its decisions equal
where JAX is sure; the kernel wrappers called as often as JAX's kernels.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from instaorder_tpu.eval import pipeline as JPL
from instaorder_tpu.models import folding as JF
from instaorder_tpu.models import resnet as jresnet
from instaorder_tpu.ops import pairs as JP
from instaorder_tpu.ops import pallas_blocks as PB
from instaorder_tpu.ops.prep_pallas import fused_prep_rgb as j_prep_rgb

from test_torch_pipeline import scene
from test_torch_pipeline_factories import KW, _nets, hold_factory

from instaorder_tpu_torch import bench as tbench
from instaorder_tpu_torch import convert, serving
from instaorder_tpu_torch.eval import pipeline as TPL
from instaorder_tpu_torch.models import folding as TF
from instaorder_tpu_torch.ops import gemm_layout
from instaorder_tpu_torch.ops import pairs as TP
from instaorder_tpu_torch.ops import prep_kernels as PK
import torch_threads  # noqa: F401 (the suite's torch thread cap)

OUT = 64
LSB = 1.0 / (255 * 0.224) + 1e-6
KFEATS = ('identity', 'down', 'stem')
JAX_KERNELS = ('fused_bottleneck', 'fused_bottleneck_down',
               'fused_bottleneck_stage', 'fused_bottleneck_stage_stream',
               'fused_bottleneck_hwnc', 'fused_stem')
HEAD_GAIN = 100.0


@pytest.fixture(scope='module')
def net():
    """The folded net (jitted init and fold: seconds, not op by op), its
    head scaled by HEAD_GAIN, and the same tree in torch."""
    box = {}

    def init(k):
        p, s, box['cfg'] = jresnet.init(k, arch='resnet50', in_channels=5,
                                        num_classes=2,
                                        layers_override=(3, 2, 1, 1))
        return JF.fold_resnet(p, s, box['cfg'])
    folded = jax.device_get(jax.jit(init)(jax.random.PRNGKey(2)))
    cfg = box['cfg']
    folded['fc'] = {k: np.asarray(v) * np.float32(HEAD_GAIN)
                    for k, v in folded['fc'].items()}
    return folded, convert.to_torch(folded), cfg


@pytest.fixture
def calls(monkeypatch):
    """JAX's kernels in interpret mode, and every kernel call of both
    packages counted by name."""
    seen = {'jax': {}, 'port': {}}

    def spy(side, name, orig, **extra):
        def f(*a, **kw):
            seen[side][name] = seen[side].get(name, 0) + 1
            return orig(*a, **dict(kw, **extra))
        return f

    for n in JAX_KERNELS:
        monkeypatch.setattr(PB, n, spy('jax', n, getattr(PB, n),
                                       interpret=True))
    for n in JAX_KERNELS[:-1]:
        monkeypatch.setattr(TF.bk16, n, spy('port', n, getattr(TF.bk16, n)))
    monkeypatch.setattr(TF, 'fused_stem',
                        spy('port', 'fused_stem', TF.fused_stem))
    return seen


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


def _jax_prep(images, masks, bboxes, pidx, route, passes):
    """The root bench's prep_all at --dtype f32 (bench.py:222-239)."""
    pj = jnp.asarray(pidx)
    if route == 'einsum':
        def prep(im, m, b):
            return JP.build_pair_batch_matmul(
                im, m, pj, JP.pair_rois(b, pj), out_size=OUT,
                dtype=jnp.float32, precision=jax.lax.Precision.HIGH)
        x = jax.vmap(prep)(jnp.asarray(images), jnp.asarray(masks),
                           jnp.asarray(bboxes))
        return np.asarray(x).reshape(-1, OUT, OUT, 5)
    rois = jax.vmap(lambda b: JP.pair_rois(b, pj))(jnp.asarray(bboxes))
    return np.asarray(JP.build_pair_batches_fused(
        jnp.asarray(images), jnp.asarray(masks), pj, rois, out_size=OUT,
        dtype=jnp.float32, passes=passes, fuse_masks=route == 'pallas5',
        interpret=True))


def _prep_close(got, want):
    """The prep bar in f32 units."""
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got[..., :2], want[..., :2])
    d = np.abs(got[..., 2:] - want[..., 2:])
    assert d.max() <= LSB and (d > 1e-5).mean() < 0.01, d.max()


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-6)


# (use_pallas, prep route, passes): the root bench's default set with its
# default prep, parity's kernel set with the RGB kernel, and the other
# feature sets with parity's einsum prep
ROUTES = [(True, 'pallas5', 1), (KFEATS, 'pallas', 3),
          (('stage',), 'einsum', 3), (('sstage',), 'einsum', 3),
          (('hwnc',), 'pallas5', 3)]


@pytest.mark.parametrize('directions', [1, 2])
@pytest.mark.parametrize('use_pallas,prep_rgb,passes', ROUTES)
def test_f32_megastep_matches_jax(net, calls, use_pallas, prep_rgb, passes,
                                  directions):
    """serving.megastep on the f32 model (the root bench's --dtype f32:
    bench.py:190, 329-345) against JAX's apply_folded[_siamese] at
    dtype=jnp.float32 on the port's own pair batch, which is held
    against JAX's prep first."""
    folded, tf, cfg = net
    images, masks, bboxes, pidx = _scenes()
    sc = [torch.from_numpy(a) for a in (images, masks, bboxes)]
    assert serving.compute_dtype(tf) == torch.float32
    kw = dict(out_size=OUT, passes=passes, prep_rgb=prep_rgb)
    x = serving.prep_pairs(*sc, pidx, dtype=torch.float32, **kw).numpy()
    _prep_close(x, _jax_prep(images, masks, bboxes, pidx, prep_rgb, passes))
    logits, ij, ji = serving.megastep(tf, cfg, *sc, pidx, **kw,
                                      directions=directions,
                                      use_pallas=use_pallas)
    if directions == 2:
        want = JF.apply_folded_siamese(folded, cfg, jnp.asarray(x),
                                       dtype=jnp.float32,
                                       use_pallas=use_pallas)
    else:
        want = (JF.apply_folded(folded, cfg, jnp.asarray(x),
                                dtype=jnp.float32, use_pallas=use_pallas),)
        logits = (logits,)
    for g, w in zip(logits, want):
        assert g.dtype == torch.float32 and g.shape == (6, 2)
        assert _rel(g.numpy(), w) <= 1e-5, _rel(g.numpy(), w)
        assert float(np.abs(np.asarray(w)).max()) > 0.1
    # decisions equal where JAX is sure
    s = [1.0 / (1.0 + np.exp(-np.asarray(w, np.float64))) for w in want]
    p_ij, p_ji = ((s[0][:, 1] + s[1][:, 0]) / 2,
                  (s[0][:, 0] + s[1][:, 1]) / 2) if directions == 2 \
        else (s[0][:, 1], s[0][:, 0])
    for p, dec in ((p_ij, ij), (p_ji, ji)):
        # (the swap average of this random net's directions stays near
        # 0.5: at directions=2 no decision may be sure)
        sure = np.abs(p - 0.5) > 1e-2
        assert sure.any() or directions == 2
        np.testing.assert_array_equal(dec.numpy()[sure], p[sure] > 0.5)
    assert calls['port'] == calls['jax'] and calls['port'], calls


def test_f32_resolves_like_the_root_bench():
    """--dtype f32 runs the folded f32 model with the bf16 default
    feature set, its prep in f32; no calibration batch is needed."""
    args = tbench.build_parser().parse_args(['--dtype', 'f32'])
    prof = tbench.resolve(args)
    assert (prof['dtype'], prof['directions'], prof['prep_rgb']) == (
        'f32', 1, 'pallas5')
    q, cfg = serving.build_model('serving-d1', 0, None, device='cpu',
                                 dtype='f32', weight_init='kaiming_out')
    assert serving.compute_dtype(q) == torch.float32
    assert set(q['conv1']) == {'w', 'b'}       # no kernel weights on the CPU
    assert all(t.dtype == torch.float32 for t in (
        q['conv1']['w'], q['layer4'][0]['down']['b'], q['fc']['w']))
    images, masks, bboxes, pidx = _scenes(seed=4)
    sc = serving.upload_scenes(images, masks, bboxes, device='cpu')
    for prep_rgb in ('einsum', 'pallas', 'pallas5'):
        x = serving.prep_pairs(*sc, pidx, out_size=OUT, prep_rgb=prep_rgb,
                               dtype=torch.float32)
        assert x.dtype == torch.float32 and x.shape == (6, OUT, OUT, 5)
    logits, ij, _ = serving.megastep(q, cfg, *sc, pidx, out_size=OUT)
    assert logits.dtype == torch.float32 and logits.shape == (6, 2)
    assert torch.isfinite(logits).all() and ij.shape == (6,)


# ---- kernel 5's f32-output mode ---------------------------------------------


def _prep_scenes(seed, S=2, H=96, W=128, N=4):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 255, (S, H, W, 3)).astype(np.float32)
    masks = (rng.rand(S, N, H, W) > 0.6).astype(np.float32)
    bboxes = np.zeros((S, N, 4), np.float32)
    for s in range(S):
        for k in range(N):
            y0, x0 = rng.randint(0, H - 20), rng.randint(0, W - 20)
            hh, ww = rng.randint(5, 60, 2)
            bboxes[s, k] = [x0, y0, ww, hh]
    pidx, _ = JP.all_pair_indices(N)
    rois = np.array(jax.vmap(lambda b: JP.pair_rois(b, jnp.asarray(pidx)))(
        jnp.asarray(bboxes)))
    return images, masks, pidx, rois


@pytest.mark.parametrize('passes', [3, 1])
@pytest.mark.parametrize('normalize', [True, False])
def test_prep_rgb_f32_out_matches_pallas_f32(passes, normalize):
    """fused_prep_rgb(out_dtype=f32) against the JAX kernel's f32 output
    in interpret mode (one uint8 LSB: 1 / (255 * 0.224) normalised, 1 on
    the raw integers); the bf16 mode is the f32 mode rounded."""
    images, _, _, rois = _prep_scenes(10 + passes + 2 * normalize)
    want = np.transpose(np.asarray(j_prep_rgb(
        jnp.asarray(images), jnp.asarray(rois), out_size=OUT,
        normalize=normalize, out_dtype=jnp.float32, passes=passes,
        interpret=True)), (0, 2, 3, 1))
    args = (torch.from_numpy(images), torch.from_numpy(rois))
    got = PK.fused_prep_rgb(*args, out_size=OUT, normalize=normalize,
                            passes=passes, out_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == (12, OUT, OUT, 3)
    d = np.abs(got.numpy() - want)
    assert d.max() <= (LSB if normalize else 1.0), d.max()
    assert (d > 1e-5).mean() < 0.01, (d > 1e-5).mean()
    b16 = PK.fused_prep_rgb(*args, out_size=OUT, normalize=normalize,
                            passes=passes)
    assert torch.equal(b16, got.bfloat16())
    with pytest.raises(ValueError, match='out_dtype'):
        PK.fused_prep_rgb(*args, out_size=OUT, out_dtype=torch.float16)


@pytest.mark.parametrize('passes', [3, 1])
def test_pair_batches_rgb_route_f32_matches_jax(passes):
    """build_pair_batches_fused's RGB-kernel route (fuse_masks=False) at
    f32 against the JAX one: masks exact, RGB within one LSB."""
    images, masks, pidx, rois = _prep_scenes(20 + passes)
    want = np.asarray(JP.build_pair_batches_fused(
        jnp.asarray(images), jnp.asarray(masks), jnp.asarray(pidx),
        jnp.asarray(rois), out_size=OUT, passes=passes, dtype=jnp.float32,
        interpret=True))
    got = TP.build_pair_batches_fused(
        torch.from_numpy(images), torch.from_numpy(masks), pidx,
        torch.from_numpy(rois), out_size=OUT, passes=passes,
        dtype=torch.float32)
    assert got.dtype == torch.float32
    _prep_close(got.numpy(), want)


# ---- the f32 predictor with kernels -----------------------------------------


@pytest.fixture
def interpret(monkeypatch):
    for n in JAX_KERNELS:
        orig = getattr(PB, n)
        monkeypatch.setattr(PB, n, (lambda o: lambda *a, **kw: o(
            *a, **dict(kw, interpret=True)))(orig))


@pytest.mark.parametrize('use_pallas,prep_impl', [
    (KFEATS, 'pallas5'), (KFEATS, 'einsum'), (True, 'pallas5'),
    (('hwnc', 'down', 'stem'), 'pallas5')])
def test_folded_f32_kernel_predictor_matches_jax(interpret, use_pallas,
                                                 prep_impl):
    """make_folded_predictor(dtype=None, use_pallas=...) on the CPU (the
    kernels' plain versions) against JAX's with the same kernels: the
    batch at the prep bar, the logits on JAX's batch within 1e-5, the
    matrices equal."""
    method = 'InstaOrderNet_o'
    j, t = _nets(method)
    kw = dict(KW, prep_impl=prep_impl)
    jp = JPL.make_folded_predictor(*j[:3], method, use_pallas=use_pallas,
                                   prep_interpret=True, **kw)
    tp = TPL.make_folded_predictor(*t[:3], method, use_pallas=use_pallas,
                                   device='cpu', **kw)
    assert tp.prep_dtype == torch.float32
    assert tp.params['conv1']['w'].dtype == torch.float32
    hold_factory(jp, tp, *scene(23, n=5), bar=1e-5, exact=True, dual=False)


# ---- the host-side layouts of the f32 kernels -------------------------------


def test_f32_k_step_rule():
    """The K step counts elements of the operand type: 128 bytes, 64
    bf16 (and int8 widened to bf16) or 32 f32. The K-packed projection's
    first segment must be a whole number of steps of its type."""
    assert gemm_layout.BF16_K_STEP * 2 == gemm_layout.F32_K_STEP * 4 == 128
    step = gemm_layout.F32_K_STEP
    assert gemm_layout.check_k_steps([64, 256], step) == [2, 8]
    assert gemm_layout.check_k_steps([96, 40], step) == [3, 2]
    for ks in ([48, 64], [80, 256]):
        with pytest.raises(ValueError, match='straddle'):
            gemm_layout.check_k_steps(ks, step)
    # K = 96 is whole at f32 but straddles a bf16 step
    with pytest.raises(ValueError, match='straddle'):
        gemm_layout.check_k_steps([96, 64], gemm_layout.BF16_K_STEP)


@pytest.mark.parametrize('bn', [64, 128])
def test_f32_gemm_thread_tile_covers_the_cta_tile(bn):
    """csrc/bottleneck_f32.cu's tiles: the wgmma m64nBN accumulators of
    the two warpgroups (conv_gemm.cuh frag_row / frag_col: element 4 j +
    e of thread tid holds row 64 (tid / 128) + 16 (warp % 4) + lane / 4
    + 8 (e / 2), column 8 j + 2 (lane % 4) + e % 2) own every (row,
    column) of the 128 x bn tile once, and the epilogue's 16-byte
    copy-out of the staged tile (f32 and int8 output) writes every
    output byte of the tile once."""
    owned = np.zeros((128, bn), np.int32)
    for tid in range(256):
        lane, warp = tid % 32, tid // 32
        for j in range(bn // 8):
            for e in range(4):
                row = 64 * (tid // 128) + 16 * (warp % 4) + lane // 4 \
                    + 8 * (e // 2)
                owned[row, 8 * j + 2 * (lane % 4) + e % 2] += 1
    assert (owned == 1).all()
    for oes in (4, 1):
        cpo = bn * oes // 16
        written = np.zeros((128, bn * oes), np.int32)
        for tid in range(256):
            for e in range(tid, 128 * cpo, 256):
                row, ch = divmod(e, cpo)
                written[row, 16 * ch:16 * ch + 16] += 1
        assert (written == 1).all()


# ---- the f32 GEMM's 3xTF32 method and its split weights --------------------


def _tf32_np(a):
    """numpy model of cvt.rna.tf32.f32 (10 mantissa bits, ties away from
    zero), independent of gemm_layout.tf32."""
    a = np.asarray(a, np.float32)
    m, e = np.frexp(a.astype(np.float64))          # |m| in [0.5, 1)
    r = np.sign(m) * np.floor(np.abs(m) * 2.0 ** 11 + 0.5) / 2.0 ** 11
    return np.ldexp(r, e).astype(np.float32)


def test_tf32_rounds_like_cvt_rna():
    """gemm_layout.tf32: ties away from zero, a carry into the exponent,
    negative values, zero, and random values against the numpy model."""
    got = gemm_layout.tf32(torch.tensor(
        [1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -12, 2 - 2 ** -12, 0.0,
         -3.0, 1 + 3 * 2 ** -11], dtype=torch.float32))
    assert got.tolist() == [1 + 2 ** -10, -(1 + 2 ** -10), 1.0, 2.0, 0.0,
                            -3.0, 1 + 2 ** -9]
    x = (np.random.RandomState(5).randn(10000)
         * 10.0 ** np.random.RandomState(6).uniform(-6, 6, 10000)
         ).astype(np.float32)
    np.testing.assert_array_equal(
        gemm_layout.tf32(torch.from_numpy(x)).numpy(), _tf32_np(x))


@pytest.mark.parametrize('shape', [(1, 1, 64, 128), (3, 3, 64, 64),
                                   (256, 512)])
def test_split_kmajor_f32(shape):
    """split_kmajor_f32: one contiguous (2, Cout, K) tensor [hi, lo] in
    kmajor's im2col order; hi and lo are TF32 (low 13 mantissa bits 0),
    hi = tf32(w), w - hi is exact in f32, |lo| <= 2^-11 |w| and hi + lo
    is within 2^-22 |w| of w (two TF32 halves keep 22 of f32's 24
    significant bits; the kernel drops lo . lo at the same order)."""
    rng = np.random.RandomState(len(shape) + shape[-1])
    w = torch.as_tensor(rng.randn(*shape) * 0.05, dtype=torch.float32)
    wk = gemm_layout.split_kmajor_f32(w)
    k = gemm_layout.kmajor(w)
    cout = shape[-1]
    assert wk.shape == (2, cout, k.shape[1]) and wk.is_contiguous()
    assert wk.dtype == torch.float32
    assert int((wk.view(torch.int32) & 0x1fff).count_nonzero()) == 0
    hi, lo = wk[0].numpy(), wk[1].numpy()
    kn = k.numpy()
    np.testing.assert_array_equal(hi, _tf32_np(kn))
    r = kn - hi
    np.testing.assert_array_equal(hi + r, kn)          # exact subtraction
    np.testing.assert_array_equal(lo, _tf32_np(r))
    assert (np.abs(lo) <= 2.0 ** -11 * np.abs(kn)).all()
    err = np.abs(hi.astype(np.float64) + lo - kn)
    assert (err <= 2.0 ** -22 * np.abs(kn)).all()
    # im2col order: K index (dy * kw + dx) * Cin + c of output channel n
    wn = w.numpy().reshape(-1, cout)
    np.testing.assert_array_equal(hi, _tf32_np(wn.T))
    with pytest.raises(ValueError, match='f32'):
        gemm_layout.split_kmajor_f32(w.bfloat16())


def _split_np(a):
    hi = _tf32_np(a)
    return hi, _tf32_np(a - hi)


def _rz_np(x):
    """f64 values rounded toward zero to f32."""
    r = x.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(x)
    return np.where(over, np.nextafter(r, np.float32(0)), r)


def _tf32_gemm_np(a, b, products, order='kernel', fresh=True):
    """numpy model of the f32 kernel's sums. Each wgmma k8 adds its 8
    TF32 products (exact: 11 x 11 bits) into the f32 accumulator, and
    the tensor cores truncate that add: rounded toward zero. A
    32-element K step issues, in the kernel's order, the small products
    of its four k8s (products 3: lo_a . hi_b then hi_a . lo_b; 2, an
    int8 A: hi_a . lo_b) and then their four hi_a . hi_b (products 1:
    hi_a . hi_b alone); order 'interleaved' takes each k8's products in
    turn instead. fresh: the accumulator starts at zero every step and
    the step's sum is added into the f32 total rounded to nearest (the
    kernel); else one accumulator runs over all of K."""
    ah, al = (t.astype(np.float64) for t in _split_np(a))
    bh, bl = (t.astype(np.float64) for t in _split_np(b))
    small = {1: [], 2: [(ah, bl)], 3: [(al, bh), (ah, bl)]}[products]
    tot = np.zeros((a.shape[0], b.shape[1]), np.float32)
    acc = tot.copy()
    for k0 in range(0, a.shape[1], 32):
        k8s = [slice(k0 + 8 * i, k0 + 8 * i + 8) for i in range(4)]
        if order == 'kernel':
            seq = ([(x, y, s) for s in k8s for x, y in small]
                   + [(ah, bh, s) for s in k8s])
        else:
            seq = [(x, y, s) for s in k8s for x, y in small + [(ah, bh)]]
        if fresh:
            acc = np.zeros_like(tot)
        for x, y, s in seq:
            acc = _rz_np(acc.astype(np.float64) + x[:, s] @ y[s])
        if fresh:
            tot = (tot + acc).astype(np.float32)
    return tot if fresh else acc


def _gemm_case(k):
    """A relu'd h (128, k) times weights of unit output scale, and their
    f64 product."""
    rng = np.random.RandomState(k)
    a = np.maximum(rng.randn(128, k), 0).astype(np.float32)
    b = (rng.randn(k, 64) / np.sqrt(k)).astype(np.float32)
    return a, b, a.astype(np.float64) @ b.astype(np.float64)


def _bias(got, ref):
    """Mean signed error relative to ref over outputs above a tenth of
    max |ref| (negative: a bias toward zero)."""
    sel = np.abs(ref) > 0.1 * np.abs(ref).max()
    return float(((got.astype(np.float64) - ref)[sel] / ref[sel]).mean())


@pytest.mark.parametrize('k', [64, 576, 1152, 2304, 4608])
def test_3xtf32_meets_the_f32_bar_and_1xtf32_misses_it(k):
    """At the trunk's K (layer1's conv1 64 ... layer4's 3x3 4,608) the
    3xTF32 sums, with the tensor cores' truncated adds, stay within the
    f32 block bar (2e-5 of max |ref|, ref the f64 product of the f32
    operands) with a wide margin, while a single TF32 product misses it:
    why the kernel issues three."""
    a, b, ref = _gemm_case(k)
    scale = np.abs(ref).max()
    err3 = np.abs(_tf32_gemm_np(a, b, 3) - ref).max() / scale
    err1 = np.abs(_tf32_gemm_np(a, b, 1) - ref).max() / scale
    assert err3 <= 2e-5 / 10, err3
    assert err1 > 2e-5, err1


@pytest.mark.parametrize('k', [576, 4608])
def test_3xtf32_truncated_sums_order_and_fresh_accumulator(k):
    """The truncated adds bias every sum toward zero. The kernel's form
    (a fresh accumulator a K step, its small products first and its
    four hi . hi last) keeps that bias near -9e-8 of the output at any
    K, as measured on the card (-7.4e-8 to -8.8e-8); taking each k8's
    products in turn (the first build) more than doubles it, and one
    accumulator over all of K lets it grow with K until, at layer4's
    K = 4,608, the sums miss the f32 bar."""
    a, b, ref = _gemm_case(k)
    scale = np.abs(ref).max()
    bias = _bias(_tf32_gemm_np(a, b, 3), ref)
    assert -1.5e-7 < bias < -3e-8, bias
    inter = _bias(_tf32_gemm_np(a, b, 3, order='interleaved'), ref)
    assert inter < 2 * bias, (inter, bias)
    one = _tf32_gemm_np(a, b, 3, fresh=False)
    assert _bias(one, ref) < 10 * bias
    if k == 4608:
        assert np.abs(one - ref).max() / scale > 2e-5


def test_int8_a_takes_two_products():
    """An int8 A is exact in TF32, so lo = 0: its two-product form equals
    the three-product one bit for bit, truncated adds and all (adding
    the zero lo . hi products leaves the accumulator as it was)."""
    rng = np.random.RandomState(9)
    a = rng.randint(-128, 128, (64, 256)).astype(np.float32)
    b = rng.randn(256, 64).astype(np.float32)
    hi, lo = _split_np(a)
    np.testing.assert_array_equal(hi, a)
    assert not lo.any()
    np.testing.assert_array_equal(_tf32_gemm_np(a, b, 2),
                                  _tf32_gemm_np(a, b, 3))


def test_add_f32_block_weights_folded(net):
    """Every block of the folded f32 tree gets `wk` = the split K-major
    [w1, w2, w3(, wd)]; the JAX-layout weights stay as they were."""
    _folded, tf, _cfg = net
    tree = {k: tf[k] for k in tf}
    for li in range(4):
        tree[f'layer{li + 1}'] = [dict(bp) for bp in tf[f'layer{li + 1}']]
    assert TF.add_f32_block_weights(tree) is tree
    n = 0
    for li in range(4):
        for bp, orig in zip(tree[f'layer{li + 1}'], tf[f'layer{li + 1}']):
            convs = [c for c in ('conv1', 'conv2', 'conv3', 'down')
                     if c in bp]
            assert len(bp['wk']) == len(convs) == (4 if 'down' in bp else 3)
            for c, wk in zip(convs, bp['wk']):
                assert bp[c] is orig[c]
                assert torch.equal(wk,
                                   gemm_layout.split_kmajor_f32(bp[c]['w']))
            n += 1
    assert n == 7 and 'wk' not in tf['layer1'][0]


@pytest.mark.parametrize('use_pallas', [KFEATS, ('stage',), ('hwnc',)])
def test_f32_forward_with_block_weights_unchanged(net, use_pallas):
    """On the CPU the plain versions do not read `wk`: the forward of a
    tree carrying it equals the forward without it, at directions 1 and
    2; tree_to carries it (as OrderPredictor.to does)."""
    _folded, tf, cfg = net
    with_wk = TF.add_f32_block_weights(convert.tree_to(tf, 'cpu'))
    assert all('wk' in bp for bp in with_wk['layer4'])
    x = torch.as_tensor(np.random.RandomState(4).randn(3, OUT, OUT, 5),
                        dtype=torch.float32)
    for fwd in (TF.apply_folded, TF.apply_folded_siamese):
        got = fwd(with_wk, cfg, x, dtype=torch.float32, use_pallas=use_pallas)
        want = fwd(tf, cfg, x, dtype=torch.float32, use_pallas=use_pallas)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(g, w)
