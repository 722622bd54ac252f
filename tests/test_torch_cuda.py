"""The port's CUDA kernels against their plain versions on the card, at
small and ragged shapes (chip_smoke.py covers the serving shapes).

Needs an NVIDIA GPU and nvcc; skips elsewhere. This file imports no JAX,
so on a machine without it run it without the repo's conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Bars as in chip_smoke.py: prep masks exact and RGB within one uint8 LSB
on under 1% of pixels; v2 bottleneck outputs and the q8 stem within one
int8 LSB on under 1% of elements (f32 sums in another order move rare
round() ties); bf16 blocks and the bf16 stem within 1e-2 of the output
scale, with under 1% of values more than one bf16 ulp apart; the int8c
blocks and stem equal to their plain versions on every value (s32 sums
are exact and the f32 epilogues keep the reference's order); a chain of
k v2 blocks in one call within k LSB (an identity run on under k% of
values), and of k bf16 blocks with the share beyond one ulp under
k%."""

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (the suite's torch thread cap)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope='module')
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from instaorder_tpu_torch.device import resolve_device
    return resolve_device()


def _blk(rng, dev, cin, cm, cout, down):
    t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=dev).contiguous()
    p = [t(rng.randn(cin, cm) * 0.6 / np.sqrt(cin) / 40, torch.bfloat16),
         t(rng.randn(cm) * 0.2, torch.float32),
         t(rng.randn(3, 3, cm, cm) * 1.2 / np.sqrt(9 * cm), torch.bfloat16),
         t(rng.randn(cm) * 0.2, torch.float32),
         t(rng.randn(cm, cout) * 40 / np.sqrt(cm), torch.bfloat16),
         t(rng.randn(cout) * 5, torch.float32)]
    if down:
        p += [t(rng.randn(cin, cout) / np.sqrt(cin), torch.bfloat16),
              t(rng.randn(cout) * 5, torch.float32)]
    return p


def _wk32(p):
    """A block's split K-major f32 weights (the f32 kernel's `wk`) from
    its parameter list [w1, b1, w2, b2, w3, b3(, wd, bd)]."""
    from instaorder_tpu_torch.ops.gemm_layout import split_kmajor_f32
    return [split_kmajor_f32(w) for w in p[0::2]]


def _close(got, want, bar=1, share=0.01):
    assert got.dtype == want.dtype and got.shape == want.shape
    d = (got.float() - want.float()).abs()
    assert float(d.max()) <= bar, float(d.max())
    assert float((d > 0).float().mean()) < share


@pytest.mark.parametrize('n,hw,in_dt,out_int8', [
    (3, 7, torch.int8, True), (2, 10, torch.bfloat16, False),
    (1, 16, torch.int8, False)])
def test_identity_kernel_ragged(dev, n, hw, in_dt, out_int8):
    from instaorder_tpu_torch.ops import bottleneck_kernels as BK
    rng = np.random.RandomState(n)
    x = torch.as_tensor(rng.randint(0, 128, (n, hw, hw, 64)),
                        device=dev).to(in_dt)
    p = _blk(rng, dev, 64, 64, 64, False)
    _close(BK.fused_bottleneck_i8v2_identity(x, *p, 0.45, out_int8=out_int8),
           BK.fused_bottleneck_i8v2_identity_plain(x, *p, 0.45,
                                                   out_int8=out_int8))


@pytest.mark.parametrize('hw', [8, 9, 14])
def test_down_s2_kernel_ragged(dev, hw):
    from instaorder_tpu_torch.ops import bottleneck_kernels as BK
    rng = np.random.RandomState(hw)
    x = torch.as_tensor(rng.randint(0, 128, (3, hw, hw, 64)), device=dev,
                        dtype=torch.int8)
    p = _blk(rng, dev, 64, 64, 128, True)
    got = BK.fused_bottleneck_i8v2_down_s2(x, *p, out_int8=False)
    assert got.shape[1] == (hw + 1) // 2
    _close(got, BK.fused_bottleneck_i8v2_down_s2_plain(x, *p, out_int8=False))


def test_stage_kernel(dev):
    from instaorder_tpu_torch.ops import bottleneck_kernels as BK
    rng = np.random.RandomState(7)
    x = torch.as_tensor(rng.randint(0, 128, (2, 12, 12, 64)), device=dev,
                        dtype=torch.int8)
    down = _blk(rng, dev, 64, 64, 256, True)
    blocks = [_blk(rng, dev, 256, 64, 256, False) for _ in range(2)]
    before = BK.fused_bottleneck_i8v2_stage.launches
    got = BK.fused_bottleneck_i8v2_stage(x, down, blocks, [0.5, 0.7])
    assert BK.fused_bottleneck_i8v2_stage.launches == before + 1
    _close(got, BK.fused_bottleneck_i8v2_stage_plain(x, down, blocks,
                                                     [0.5, 0.7]), bar=3)


def test_kernel_wrappers_refuse_bad_inputs(dev):
    """A float x must be in the weights' compute dtype: f32 x with bf16
    weights and bf16 x with f32 weights raise. int8 x with f32 weights
    (the v2 model at compute_dtype=f32) launches the f32 mode on the
    split weights, and raises without them."""
    from instaorder_tpu_torch.ops import bottleneck_kernels as BK
    rng = np.random.RandomState(0)
    p = _blk(rng, dev, 64, 64, 64, False)
    x = torch.zeros((1, 8, 8, 64), dtype=torch.float32, device=dev)
    with pytest.raises(ValueError):
        BK.fused_bottleneck_i8v2_identity(x, *p, 0.5)
    p32 = [a.float() for a in p]
    with pytest.raises(ValueError):
        BK.fused_bottleneck_i8v2_identity(x.bfloat16(), *p32, 0.5)
    x8 = torch.as_tensor(rng.randint(0, 128, (1, 8, 8, 64)), device=dev,
                         dtype=torch.int8)
    with pytest.raises(ValueError, match='wk='):
        BK.fused_bottleneck_i8v2_identity(x8, *p32, 0.5)
    before = BK.fused_bottleneck_i8v2_identity.launches
    got = BK.fused_bottleneck_i8v2_identity(x8, *p32, 0.5, wk=_wk32(p32))
    assert BK.fused_bottleneck_i8v2_identity.launches == before + 1
    _close(got, BK.fused_bottleneck_i8v2_identity_plain(x8, *p32, 0.5))


@pytest.mark.parametrize('passes', [1, 3])
def test_prep_kernel_odd_sizes(dev, passes):
    from instaorder_tpu_torch import serving
    from instaorder_tpu_torch.ops import pairs as P
    from instaorder_tpu_torch.ops import prep_kernels as PK
    images, masks, bboxes = serving.synthetic_scenes(2, 131, 203, 4, seed=3)
    sc = serving.upload_scenes(images, masks, bboxes, device=dev)
    pidx = torch.as_tensor(P.all_pair_indices(4)[0], device=dev)
    rois = P.pair_rois(sc[2], pidx).contiguous()
    rois[0, 0] = torch.tensor([-40.0, -30.0, 260.0, 260.0])  # off-image
    got = PK.fused_prep_pairs(sc[0], sc[1], pidx, rois, out_size=72,
                              passes=passes)
    want = PK.fused_prep_pairs_plain(sc[0], sc[1], pidx, rois, out_size=72,
                                     passes=passes)
    assert bool((got[..., :2] == want[..., :2]).all())
    d = (got[..., 2:].float() - want[..., 2:].float()).abs()
    assert float(d.max()) <= 0.03125 + 1e-6
    assert float((d > 0).float().mean()) < 0.01


def _adversarial_rois(out_size, w):
    """(2, 9, 4) xywh crops of 1, 2, 3, out/2, out, 3*out and 5*out
    pixels, negative offsets, one wholly outside the image, one not
    square (the same sizes at other offsets on scene 1)."""
    o = out_size
    r0 = [[3, 4, 1, 1], [-1, 7, 2, 2], [w - 2, -2, 3, 3],
          [5, 9, o // 2, o // 2], [-6, -5, o, o], [-20, -11, 3 * o, 3 * o],
          [-30, -40, 5 * o, 5 * o], [w + 5, -300, o, o], [3, 2, 7, 45]]
    r1 = [[x + 2 * i - 5, y - i, sx, sy]
          for i, (x, y, sx, sy) in enumerate(r0)]
    return torch.tensor([r0, r1], dtype=torch.float32)


@pytest.mark.parametrize('passes', [1, 3])
@pytest.mark.parametrize('out_size', [72, 256, 300])
def test_prep_kernels_adversarial_rois_exact(dev, out_size, passes):
    """Both prep kernels equal their plain versions on every value, one
    launch a call, on odd image sizes and adversarial crops (300: the
    columns split into two tiles). The plain versions run on the CPU:
    on the card PyTorch divides by a Python scalar as a multiply by its
    reciprocal, which moves a tap position by one ulp where out_size is
    not a power of two; the kernel and the CPU divide."""
    from instaorder_tpu_torch import serving
    from instaorder_tpu_torch.ops import prep_kernels as PK
    images, masks, _ = serving.synthetic_scenes(2, 131, 203, 4, seed=11)
    sc = serving.upload_scenes(images, masks, np.zeros((2, 4, 4)),
                               device=dev)
    rng = np.random.RandomState(out_size + passes)
    pidx = torch.as_tensor(rng.randint(0, 4, (9, 2)), dtype=torch.int32,
                           device=dev)
    rois = _adversarial_rois(out_size, 203).to(dev)
    host = [t.cpu() for t in (sc[0], sc[1], pidx, rois)]
    before = PK.fused_prep_pairs.launches
    got = PK.fused_prep_pairs(sc[0], sc[1], pidx, rois, out_size=out_size,
                              passes=passes)
    assert PK.fused_prep_pairs.launches == before + 1
    want = PK.fused_prep_pairs_plain(*host, out_size=out_size,
                                     passes=passes)
    assert got.shape == want.shape == (18, out_size, out_size, 5)
    n = int((got.cpu().float() != want.float()).sum())
    assert n == 0, f'{n} differing values'
    for normalize in (True, False):
        before = PK.fused_prep_rgb.launches
        got = PK.fused_prep_rgb(sc[0], rois, out_size=out_size,
                                normalize=normalize, passes=passes)
        assert PK.fused_prep_rgb.launches == before + 1
        want = PK.fused_prep_rgb_plain(host[0], host[3], out_size=out_size,
                                       normalize=normalize, passes=passes)
        assert got.shape == want.shape == (18, out_size, out_size, 3)
        n = int((got.cpu().float() != want.float()).sum())
        assert n == 0, f'{n} differing values (normalize={normalize})'


def _f32_close(got, want, bar=2e-5):
    """The f32 bar: max |got - want| <= bar * max |want| (2e-5 for blocks
    and the GEMM, per chained block; 1e-5 for the stem), over 5% of the
    values nonzero."""
    assert got.dtype == want.dtype == torch.float32
    assert got.shape == want.shape
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= bar * scale, (err, scale)
    assert float((want != 0).float().mean()) > 0.05, 'degenerate test data'


def _bf16_close(got, want):
    """max |got - want| <= 1e-2 max |want|; under 1% of values more than
    one bf16 ulp (of the plain value) apart."""
    assert got.dtype == want.dtype == torch.bfloat16
    assert got.shape == want.shape
    g, w = got.float(), want.float()
    d = (g - w).abs()
    assert float(d.max()) <= 1e-2 * float(w.abs().max()), float(d.max())
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(1e-30))) - 7)
    assert float((d > ulp).float().mean()) < 0.01
    assert float((w != 0).float().mean()) > 0.05, 'degenerate test data'


def _bf16_blk(rng, dev, cin, cm, cout, down):
    t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=dev).contiguous()
    p = [t(rng.randn(cin, cm) / np.sqrt(cin), torch.bfloat16),
         t(rng.randn(cm) * 0.1, torch.float32),
         t(rng.randn(3, 3, cm, cm) / np.sqrt(9 * cm), torch.bfloat16),
         t(rng.randn(cm) * 0.1, torch.float32),
         t(rng.randn(cm, cout) / np.sqrt(cm), torch.bfloat16),
         t(rng.randn(cout) * 0.1, torch.float32)]
    if down:
        p += [t(rng.randn(cin, cout) / np.sqrt(cin), torch.bfloat16),
              t(rng.randn(cout) * 0.1, torch.float32)]
    return p


@pytest.mark.parametrize('n,hw', [(1, 7), (3, 10), (2, 13)])
def test_bf16_identity_kernel_ragged(dev, n, hw):
    from instaorder_tpu_torch.ops import bottleneck_bf16_kernels as B16
    rng = np.random.RandomState(10 + n)
    x = torch.as_tensor(rng.randn(n, hw, hw, 64), dtype=torch.bfloat16,
                        device=dev)
    p = _bf16_blk(rng, dev, 64, 64, 64, False)
    before = B16.fused_bottleneck.launches
    got = B16.fused_bottleneck(x, *p)
    assert B16.fused_bottleneck.launches == before + 1
    _bf16_close(got, B16.fused_bottleneck_plain(x, *p))


@pytest.mark.parametrize('stride,n,hw', [(1, 3, 9), (2, 1, 9), (2, 3, 14)])
def test_bf16_down_kernel_ragged(dev, stride, n, hw):
    from instaorder_tpu_torch.ops import bottleneck_bf16_kernels as B16
    rng = np.random.RandomState(20 + hw)
    x = torch.as_tensor(rng.randn(n, hw, hw, 64), dtype=torch.bfloat16,
                        device=dev)
    p = _bf16_blk(rng, dev, 64, 64, 128, True)
    got = B16.fused_bottleneck_down(x, *p, stride=stride)
    assert got.shape[1] == (hw - 1) // stride + 1
    _bf16_close(got, B16.fused_bottleneck_down_plain(x, *p, stride=stride))


@pytest.mark.parametrize('dt', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('n,hw,cout,q8', [
    (1, 36, 64, False), (3, 50, 128, False), (2, 30, 128, True),
    (3, 64, 64, True)])
def test_stem_kernel_ragged(dev, n, hw, cout, q8, dt):
    """Pooled sizes 9, 13, 8, 16: tiles of 8 pooled rows that do not
    divide the output, and odd conv sizes; bf16 and f32, each also q8."""
    from instaorder_tpu_torch.ops import stem_kernels as SK
    rng = np.random.RandomState(hw)
    scale = 30.0 if q8 else 1.0
    x = torch.as_tensor(rng.randn(n, hw, hw, 5), dtype=dt, device=dev)
    w = torch.as_tensor(rng.randn(7, 7, 5, cout) * scale / np.sqrt(245),
                        dtype=dt, device=dev)
    b = torch.as_tensor(rng.randn(cout) * 0.1 * scale, dtype=torch.float32,
                        device=dev)
    before = SK.fused_stem.launches
    got = SK.fused_stem(x, w, b, q8=q8, wk=SK.stem_kernel_weights(w))
    assert SK.fused_stem.launches == before + 1
    want = SK.fused_stem_plain(x, w, b, q8=q8)
    ho = ((hw - 1) // 2) // 2 + 1
    assert tuple(got.shape) == (n, ho, ho, cout)
    if q8:
        _close(got, want)
        assert float(((want > 0) & (want < 127)).float().mean()) > 0.2
    elif dt == torch.float32:
        _f32_close(got, want, 1e-5)
    else:
        _bf16_close(got, want)


@pytest.mark.parametrize('cout', [64, 128])
@pytest.mark.parametrize('kind', ['q8', 'int8c', 'f32', 'f32-q8'])
def test_stem_kernels_serving_shape(dev, kind, cout):
    """The serving stems at 256^2 and a batch of 9 (persistent CTAs
    walking several work items each): q8 within one LSB on under 1% of
    outputs, f32 within 1e-5 of max |plain|, the int8c stem equal on
    every value."""
    from instaorder_tpu_torch.ops import stem_kernels as SK
    rng = np.random.RandomState(cout + len(kind))
    n = 9
    if kind != 'int8c':
        dt = torch.float32 if kind.startswith('f32') else torch.bfloat16
        q8 = kind.endswith('q8')
        scale = 30.0 if q8 else 1.0
        x = torch.as_tensor(rng.randn(n, 256, 256, 5), dtype=dt, device=dev)
        w = torch.as_tensor(rng.randn(7, 7, 5, cout) * scale / np.sqrt(245),
                            dtype=dt, device=dev)
        b = torch.as_tensor(rng.randn(cout) * 0.1 * scale,
                            dtype=torch.float32, device=dev)
        got = SK.fused_stem(x, w, b, q8=q8, wk=SK.stem_kernel_weights(w))
        want = SK.fused_stem_plain(x, w, b, q8=q8)
        if q8:
            _close(got, want)
            assert float(((want > 0) & (want < 127)).float().mean()) > 0.05
        else:
            _f32_close(got, want, 1e-5)
    else:
        x = torch.as_tensor(rng.randint(-127, 128, (n, 256, 256, 5)),
                            device=dev, dtype=torch.int8)
        w, m, b = _i8_conv(rng, dev, 245, cout, (7, 7, 5, cout))
        got = SK.fused_stem_int8(x, w, m, b, wk=SK.stem_kernel_weights(w))
        _exact(got, SK.fused_stem_int8_plain(x, w, m, b))
    assert tuple(got.shape) == (n, 64, 64, cout)


def test_stem_wrappers_need_kernel_weights(dev):
    """On the card both stems raise without the relaid weights, or with
    the JAX-layout ones in their place; the f32 stem also with its old
    (49 C, Cout) layout or one half of the split weights, and on odd H or
    W."""
    from instaorder_tpu_torch.ops import stem_kernels as SK
    rng = np.random.RandomState(2)
    x = torch.zeros((1, 32, 32, 5), dtype=torch.bfloat16, device=dev)
    w = torch.zeros((7, 7, 5, 64), dtype=torch.bfloat16, device=dev)
    b = torch.zeros((64,), dtype=torch.float32, device=dev)
    for wk in (None, w, SK.stem_kernel_weights(w).t()):
        with pytest.raises(ValueError, match='stem_kernel_weights'):
            SK.fused_stem(x, w, b, wk=wk)
    x32, w32 = x.float(), w.float()
    wk32 = SK.stem_kernel_weights(w32)
    assert tuple(wk32.shape) == (2, 64, 288)
    for wk in (None, w32, w32.reshape(245, 64), wk32[0], wk32.bfloat16()):
        with pytest.raises(ValueError, match='stem_kernel_weights'):
            SK.fused_stem(x32, w32, b, wk=wk)
    for shape in ((1, 31, 32, 5), (1, 32, 31, 5)):
        with pytest.raises(ValueError, match='even H, W'):
            SK.fused_stem(torch.zeros(shape, device=dev), w32, b, wk=wk32)
    x8 = torch.zeros((1, 32, 32, 5), dtype=torch.int8, device=dev)
    w8, m, b8 = _i8_conv(rng, dev, 245, 64, (7, 7, 5, 64))
    for wk in (None, w8, SK.stem_kernel_weights(w8).t()):
        with pytest.raises(ValueError, match='stem_kernel_weights'):
            SK.fused_stem_int8(x8, w8, m, b8, wk=wk)


@pytest.mark.parametrize('passes,normalize', [(1, True), (3, True),
                                              (3, False)])
def test_prep_rgb_kernel_odd_sizes(dev, passes, normalize):
    from instaorder_tpu_torch import serving
    from instaorder_tpu_torch.ops import pairs as P
    from instaorder_tpu_torch.ops import prep_kernels as PK
    images, masks, bboxes = serving.synthetic_scenes(3, 131, 203, 4, seed=5)
    sc = serving.upload_scenes(images, masks, bboxes, device=dev)
    pidx = torch.as_tensor(P.all_pair_indices(4)[0], device=dev)
    rois = P.pair_rois(sc[2], pidx).contiguous()
    rois[1, 2] = torch.tensor([-40.0, -30.0, 260.0, 260.0])  # off-image
    before = PK.fused_prep_rgb.launches
    got = PK.fused_prep_rgb(sc[0], rois, out_size=72, normalize=normalize,
                            passes=passes)
    assert PK.fused_prep_rgb.launches == before + 1
    want = PK.fused_prep_rgb_plain(sc[0], rois, out_size=72,
                                   normalize=normalize, passes=passes)
    assert got.shape == want.shape == (18, 72, 72, 3)
    d = (got.float() - want.float()).abs()
    assert float(d.max()) <= (0.03125 if normalize else 1.0) + 1e-6
    assert float((d > 0).float().mean()) < 0.01


def test_bf16_kernel_wrappers_refuse_bad_inputs(dev):
    """f32 activations launch the f32 mode (within 2e-5 of the output
    scale of the plain version; with bf16 weights they raise), the f32
    stem also with q8 (within one LSB on under 1%); non-f32 biases
    raise."""
    from instaorder_tpu_torch.ops import bottleneck_bf16_kernels as B16
    from instaorder_tpu_torch.ops import stem_kernels as SK
    rng = np.random.RandomState(0)
    p = _bf16_blk(rng, dev, 64, 64, 64, False)
    x = torch.zeros((1, 8, 8, 64), dtype=torch.float32, device=dev)
    with pytest.raises(ValueError, match='weight'):
        B16.fused_bottleneck(x, *p)
    x32 = torch.as_tensor(rng.randn(1, 8, 8, 64), dtype=torch.float32,
                          device=dev)
    p32 = [a.float() for a in p]
    before = B16.fused_bottleneck.launches
    got = B16.fused_bottleneck(x32, *p32, wk=_wk32(p32))
    _launched(B16.fused_bottleneck, before)
    _f32_close(got, B16.fused_bottleneck_plain(x32, *p32))
    pb = [a if i % 2 == 0 else a.bfloat16() for i, a in enumerate(p)]
    with pytest.raises(ValueError, match='bias'):
        B16.fused_bottleneck(x.bfloat16(), *pb)
    pd = _bf16_blk(rng, dev, 64, 64, 128, True)
    pd[7] = pd[7].bfloat16()
    with pytest.raises(ValueError, match='bias'):
        B16.fused_bottleneck_down(x.bfloat16(), *pd, stride=2)
    xs = torch.as_tensor(rng.randn(1, 32, 32, 5), dtype=torch.float32,
                         device=dev)
    w = torch.as_tensor(rng.randn(7, 7, 5, 64) / np.sqrt(245),
                        dtype=torch.float32, device=dev)
    b = torch.as_tensor(rng.randn(64) * 0.1, dtype=torch.float32, device=dev)
    before = SK.fused_stem.launches
    got = SK.fused_stem(xs, w, b, wk=SK.stem_kernel_weights(w))
    assert SK.fused_stem.launches == before + 1
    _f32_close(got, SK.fused_stem_plain(xs, w, b), 1e-5)
    with pytest.raises(ValueError, match='w must be float32'):
        SK.fused_stem(xs, w.bfloat16(), b,
                      wk=SK.stem_kernel_weights(w.bfloat16()))
    got = SK.fused_stem(xs, w * 30, b, q8=True,
                        wk=SK.stem_kernel_weights(w * 30))
    assert SK.fused_stem.launches == before + 2 and got.dtype == torch.int8
    _close(got, SK.fused_stem_plain(xs, w * 30, b, q8=True))
    with pytest.raises(ValueError, match='bias'):
        SK.fused_stem(xs.bfloat16(), w.bfloat16(), b.bfloat16())


# ---------------------------------------------------------------------------
# int8c kernels: exact integer arithmetic, so kernel and plain version
# must agree on every value
# ---------------------------------------------------------------------------


def _i8_conv(rng, dev, k, cout, shape):
    """int8 weights of `shape` and requant (m, b) that put about half of
    the outputs inside 1..126 for int8 inputs 0..127."""
    t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=dev).contiguous()
    w = t(rng.randint(-127, 128, shape), torch.int8)
    m = t(60.0 / (np.sqrt(k) * 64 * 73) * (1 + 0.2 * rng.rand(cout)),
          torch.float32)
    b = t(rng.randn(cout) * 10, torch.float32)
    return [w, m, b]


def _i8_blk(rng, dev, cin, cm, cout, down):
    p = (_i8_conv(rng, dev, cin, cm, (cin, cm))
         + _i8_conv(rng, dev, 9 * cm, cm, (3, 3, cm, cm))
         + _i8_conv(rng, dev, cm, cout, (cm, cout)))
    if down:
        p += _i8_conv(rng, dev, cin, cout, (cin, cout))
    return p


def _wk(p):
    """The K-major weights the card's int8 kernel reads, from an _i8_blk
    parameter list (w1, w2, w3 and wd are every third entry)."""
    from instaorder_tpu_torch.ops import gemm_layout as GL
    return [GL.kmajor(w) for w in p[::3]]


def _exact(got, want):
    assert got.dtype == want.dtype == torch.int8
    assert got.shape == want.shape
    assert int((got != want).sum()) == 0, int((got != want).sum())
    live = float(((want > 0) & (want < 127)).float().mean())
    assert live > 0.05, 'degenerate test data'


@pytest.mark.parametrize('n,hw,c,cm', [(3, 7, 64, 64), (2, 10, 256, 64),
                                       (1, 6, 512, 128), (2, 5, 1024, 256)])
def test_int8_identity_kernel_exact(dev, n, hw, c, cm):
    from instaorder_tpu_torch.ops import int8_kernels as IK
    rng = np.random.RandomState(30 + hw)
    x = torch.as_tensor(rng.randint(0, 128, (n, hw, hw, c)), device=dev,
                        dtype=torch.int8)
    p = _i8_blk(rng, dev, c, cm, c, False)
    wk = _wk(p)
    want = IK.fused_bottleneck_int8_plain(x, *p, 0.55)
    for fn in (IK.fused_bottleneck_int8, IK.fused_bottleneck_int8_hwnc):
        before = fn.launches
        _exact(fn(x, *p, 0.55, wk=wk), want)
        assert fn.launches == before + 1


@pytest.mark.parametrize('stride,n,hw,cin,cm,cout', [
    (1, 3, 9, 64, 64, 256), (2, 2, 9, 256, 128, 512),
    (2, 1, 7, 512, 256, 1024), (2, 2, 5, 1024, 512, 2048)])
def test_int8_projection_kernel_exact(dev, stride, n, hw, cin, cm, cout):
    """Odd planes at stride 2: the output is ceil(hw / 2)."""
    from instaorder_tpu_torch.ops import int8_kernels as IK
    rng = np.random.RandomState(40 + hw + cin)
    x = torch.as_tensor(rng.randint(0, 128, (n, hw, hw, cin)), device=dev,
                        dtype=torch.int8)
    p = _i8_blk(rng, dev, cin, cm, cout, True)
    wk = _wk(p)
    want = IK.fused_bottleneck_down_int8_plain(x, *p, stride=stride)
    assert want.shape[1] == (hw - 1) // stride + 1
    hwnc = (IK.fused_bottleneck_down_s2_int8_hwnc if stride == 2
            else IK.fused_bottleneck_down_int8_hwnc)
    before = (IK.fused_bottleneck_down_int8.launches, hwnc.launches)
    _exact(IK.fused_bottleneck_down_int8(x, *p, stride=stride, wk=wk), want)
    _exact(hwnc(x, *p, wk=wk), want)
    assert (IK.fused_bottleneck_down_int8.launches,
            hwnc.launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize('n,hw,cout', [(1, 36, 64), (3, 50, 128),
                                       (2, 30, 128), (3, 64, 64)])
def test_int8_stem_kernel_exact(dev, n, hw, cout):
    from instaorder_tpu_torch.ops import stem_kernels as SK
    rng = np.random.RandomState(50 + hw)
    x = torch.as_tensor(rng.randint(-127, 128, (n, hw, hw, 5)), device=dev,
                        dtype=torch.int8)
    w, m, b = _i8_conv(rng, dev, 245, cout, (7, 7, 5, cout))
    before = SK.fused_stem_int8.launches
    got = SK.fused_stem_int8(x, w, m, b, wk=SK.stem_kernel_weights(w))
    assert SK.fused_stem_int8.launches == before + 1
    ho = ((hw - 1) // 2) // 2 + 1
    assert tuple(got.shape) == (n, ho, ho, cout)
    _exact(got, SK.fused_stem_int8_plain(x, w, m, b))


def test_int8_kernel_wrappers_refuse_bad_inputs(dev):
    """bf16 or f32 activations, a non-contiguous activation, weights on
    the CPU beside a CUDA activation, and missing or JAX-layout kernel
    weights raise."""
    from instaorder_tpu_torch.ops import int8_kernels as IK
    from instaorder_tpu_torch.ops import stem_kernels as SK
    rng = np.random.RandomState(1)
    p = _i8_blk(rng, dev, 64, 64, 64, False)
    wk = _wk(p)
    x = torch.zeros((1, 8, 8, 64), dtype=torch.int8, device=dev)
    for bad in (x.bfloat16(), x.float(), x.transpose(1, 2)):
        with pytest.raises(ValueError):
            IK.fused_bottleneck_int8(bad, *p, 0.5, wk=wk)
    with pytest.raises(ValueError):
        IK.fused_bottleneck_int8(x, *[a.cpu() for a in p], 0.5,
                                 wk=[w.cpu() for w in wk])
    with pytest.raises(ValueError, match='K-major'):
        IK.fused_bottleneck_int8(x, *p, 0.5)
    with pytest.raises(ValueError, match='K-major'):
        IK.fused_bottleneck_int8(x, *p, 0.5, wk=[wk[0], p[3], wk[2]])
    pd = _i8_blk(rng, dev, 64, 64, 128, True)
    with pytest.raises(ValueError):
        IK.fused_bottleneck_down_int8(x.float(), *pd, stride=2,
                                      wk=_wk(pd))
    xs = torch.zeros((1, 32, 32, 5), dtype=torch.int8, device=dev)
    w, m, b = _i8_conv(rng, dev, 245, 64, (7, 7, 5, 64))
    for bad in (xs.bfloat16(), xs.float()):
        with pytest.raises(ValueError):
            SK.fused_stem_int8(bad, w, m, b)
    with pytest.raises(ValueError):
        SK.fused_stem_int8(xs, w.cpu(), m, b)


# ---------------------------------------------------------------------------
# the remaining feature sets' wrappers (kernels 6-9, 11, 12, 14 and kernel
# 2's identity-run mode): each launches the kernels above and counts its
# own launches
# ---------------------------------------------------------------------------


def _launched(fn, before):
    assert fn.launches == before + 1


@pytest.mark.parametrize('n,hw,c,cm,in_dt', [
    (3, 7, 256, 64, torch.int8), (2, 10, 512, 128, torch.bfloat16),
    (1, 9, 64, 64, torch.int8)])
def test_i8v2_nhwc_identity_kernel(dev, n, hw, c, cm, in_dt):
    from instaorder_tpu_torch.ops import bottleneck_kernels as BK
    rng = np.random.RandomState(60 + hw)
    x = torch.as_tensor(rng.randint(0, 128, (n, hw, hw, c)),
                        device=dev).to(in_dt)
    p = _blk(rng, dev, c, cm, c, False)
    before = BK.fused_bottleneck_i8v2.launches
    got = BK.fused_bottleneck_i8v2(x, *p, 0.45, out_int8=False)
    _launched(BK.fused_bottleneck_i8v2, before)
    _close(got, BK.fused_bottleneck_i8v2_plain(x, *p, 0.45, out_int8=False))


@pytest.mark.parametrize('n,hw,cin,cm,cout,out_int8', [
    (3, 9, 64, 64, 256, True), (2, 7, 512, 128, 512, False),
    (1, 12, 256, 64, 256, True)])
def test_stride1_projection_kernels(dev, n, hw, cin, cm, cout, out_int8):
    """Kernels 7 (K-packed) and 9 (two dots in its plain version)."""
    from instaorder_tpu_torch.ops import bottleneck_kernels as BK
    rng = np.random.RandomState(70 + hw)
    x = torch.as_tensor(rng.randint(0, 128, (n, hw, hw, cin)), device=dev,
                        dtype=torch.int8)
    p = _blk(rng, dev, cin, cm, cout, True)
    for fn, plain in ((BK.fused_bottleneck_down_i8v2_hwnc,
                       BK.fused_bottleneck_down_i8v2_hwnc_plain),
                      (BK.fused_bottleneck_down_i8v2,
                       BK.fused_bottleneck_down_i8v2_plain)):
        before = fn.launches
        got = fn(x, *p, out_int8=out_int8)
        _launched(fn, before)
        assert tuple(got.shape) == (n, hw, hw, cout)
        _close(got, plain(x, *p, out_int8=out_int8))


def test_hwncp_stage_kernel(dev):
    from instaorder_tpu_torch.ops import bottleneck_kernels as BK
    rng = np.random.RandomState(8)
    x = torch.as_tensor(rng.randint(0, 128, (3, 10, 10, 64)), device=dev,
                        dtype=torch.int8)
    down = _blk(rng, dev, 64, 64, 256, True)
    blocks = [_blk(rng, dev, 256, 64, 256, False) for _ in range(2)]
    before = BK.fused_bottleneck_i8v2_hwncp_stage.launches
    got = BK.fused_bottleneck_i8v2_hwncp_stage(x, down, blocks, [0.5, 0.7])
    _launched(BK.fused_bottleneck_i8v2_hwncp_stage, before)
    _close(got, BK.fused_bottleneck_i8v2_hwncp_stage_plain(
        x, down, blocks, [0.5, 0.7]), bar=3)


@pytest.mark.parametrize('n,hw,c,cm,k,out_int8', [
    (2, 12, 256, 64, 2, True), (3, 7, 512, 128, 3, False),
    (1, 5, 1024, 256, 2, True)])
def test_identity_run_stage_kernel(dev, n, hw, c, cm, k, out_int8):
    """Kernel 2 with down=None: k identity blocks, within k LSB on
    under k% of values (a flipped value is read again by the next
    block's residual and 3x3)."""
    from instaorder_tpu_torch.ops import bottleneck_kernels as BK
    rng = np.random.RandomState(80 + hw)
    x = torch.as_tensor(rng.randint(0, 128, (n, hw, hw, c)), device=dev,
                        dtype=torch.int8)
    blocks = [_blk(rng, dev, c, cm, c, False) for _ in range(k)]
    rs = [0.5, 0.6, 0.4][:k]
    before = BK.fused_bottleneck_i8v2_stage.launches
    got = BK.fused_bottleneck_i8v2_stage(x, None, blocks, rs,
                                         out_int8=out_int8)
    _launched(BK.fused_bottleneck_i8v2_stage, before)
    _close(got, BK.fused_bottleneck_i8v2_stage_plain(
        x, None, blocks, rs, out_int8=out_int8), bar=k, share=0.01 * k)


def _bf16_close_k(got, want, k):
    """_bf16_close with the share beyond one ulp allowed to grow to k%
    over a chain of k blocks."""
    g, w = got.float(), want.float()
    d = (g - w).abs()
    assert got.dtype == want.dtype == torch.bfloat16
    assert float(d.max()) <= 1e-2 * float(w.abs().max()), float(d.max())
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(1e-30))) - 7)
    assert float((d > ulp).float().mean()) < 0.01 * k
    assert float((w != 0).float().mean()) > 0.05, 'degenerate test data'


@pytest.mark.parametrize('n,hw,c,cm,k', [(2, 9, 256, 64, 2),
                                         (1, 13, 512, 128, 3)])
def test_bf16_stage_and_hwnc_kernels(dev, n, hw, c, cm, k):
    """Kernels 11, 12 (k identity blocks) and 14 (one)."""
    from instaorder_tpu_torch.ops import bottleneck_bf16_kernels as B16
    rng = np.random.RandomState(90 + hw)
    x = torch.as_tensor(rng.randn(n, hw, hw, c), dtype=torch.bfloat16,
                        device=dev)
    blocks = [_bf16_blk(rng, dev, c, cm, c, False) for _ in range(k)]
    want = B16.fused_bottleneck_stage_plain(x, blocks)
    for fn in (B16.fused_bottleneck_stage, B16.fused_bottleneck_stage_stream):
        before = fn.launches
        got = fn(x, blocks)
        _launched(fn, before)
        _bf16_close_k(got, want, k)
    before = B16.fused_bottleneck_hwnc.launches
    got = B16.fused_bottleneck_hwnc(x, *blocks[0])
    _launched(B16.fused_bottleneck_hwnc, before)
    _bf16_close(got, B16.fused_bottleneck_hwnc_plain(x, *blocks[0]))


def test_variant_wrappers_refuse_bad_inputs(dev):
    """f32 activations, channels the GEMM does not tile, empty stages and
    an hwncp stage without its projection raise; none falls back."""
    from instaorder_tpu_torch.ops import bottleneck_bf16_kernels as B16
    from instaorder_tpu_torch.ops import bottleneck_kernels as BK
    rng = np.random.RandomState(2)
    p = _blk(rng, dev, 64, 64, 64, False)
    x = torch.zeros((1, 8, 8, 64), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError):
        BK.fused_bottleneck_i8v2(x.float(), *p, 0.5)
    pd = _blk(rng, dev, 48, 64, 128, True)
    with pytest.raises(ValueError, match='multiple of 32'):
        BK.fused_bottleneck_down_i8v2(
            torch.zeros((1, 8, 8, 48), dtype=torch.int8, device=dev), *pd)
    with pytest.raises(ValueError, match='at least one block'):
        BK.fused_bottleneck_i8v2_stage(x, None, [], [])
    with pytest.raises(ValueError, match='projection'):
        BK.fused_bottleneck_i8v2_hwncp_stage(x, None, [p], [0.5])
    with pytest.raises(ValueError, match='one residual scale'):
        BK.fused_bottleneck_i8v2_stage(x, None, [p], [])
    pb = _bf16_blk(rng, dev, 64, 64, 64, False)
    pf = [a.float() for a in pb]
    xf = torch.as_tensor(rng.randn(1, 8, 8, 64), dtype=torch.float32,
                         device=dev)
    # f32 activations launch the f32 mode (no fallback to a plain chain)
    for fn in (B16.fused_bottleneck_stage, B16.fused_bottleneck_stage_stream):
        before = fn.launches
        got = fn(xf, [pf], wk=[_wk32(pf)])
        _launched(fn, before)
        _f32_close(got, B16.fused_bottleneck_stage_plain(xf, [pf]))
        with pytest.raises(ValueError, match='at least one block'):
            fn(xf.bfloat16(), [])
    before = B16.fused_bottleneck_hwnc.launches
    got = B16.fused_bottleneck_hwnc(xf, *pf, wk=_wk32(pf))
    _launched(B16.fused_bottleneck_hwnc, before)
    _f32_close(got, B16.fused_bottleneck_hwnc_plain(xf, *pf))


# ---------------------------------------------------------------------------
# the tiling of the implicit-GEMM kernels, one launch at a time: the
# 128 x 64 tile (Cout = 64) and the widest layer (Cout = 2048), rows that
# do not fill the last 128-row tile, a single K step, the stride-2 3x3 at
# the image's edges, the K-packed bf16 projection with an int8 A segment
# and the int8 two-segment projection
# ---------------------------------------------------------------------------


def _bf16(rng, dev, *shape, scale=1.0):
    return torch.as_tensor(rng.randn(*shape) * scale, dtype=torch.bfloat16,
                           device=dev)


@pytest.mark.parametrize('n,hw,cin,cout', [
    (1, 7, 64, 64),        # one K step, M = 49, the 128 x 64 tile
    (2, 9, 96, 128),       # K = 96: a ragged second step, M = 162
    (2, 5, 512, 2048)])    # Cout = 2048, M = 50
def test_gemm_1x1_tiles(dev, n, hw, cin, cout):
    from instaorder_tpu_torch.ops import bottleneck_kernels as BK
    rng = np.random.RandomState(100 + cin)
    x = _bf16(rng, dev, n, hw, hw, cin)
    w = _bf16(rng, dev, cin, cout, scale=1 / np.sqrt(cin))
    b = torch.as_tensor(rng.randn(cout) * 0.1, dtype=torch.float32,
                        device=dev)
    out = torch.empty((n, hw, hw, cout), dtype=torch.bfloat16, device=dev)
    got = BK._gemm(out, [(x, w, 1, 1)], b, BK._RELU_BF16)
    _bf16_close(got, torch.relu(x.float() @ w.float() + b).bfloat16())


@pytest.mark.parametrize('n,hw,c,cout,stride', [
    (2, 9, 64, 64, 2), (1, 14, 128, 128, 2), (3, 6, 64, 128, 1)])
def test_gemm_3x3_edges(dev, n, hw, c, cout, stride):
    """The 3x3 halo at every edge; at stride 2 an odd plane puts the last
    output's window on the bottom and right edges."""
    from instaorder_tpu_torch.ops import bottleneck_kernels as BK
    rng = np.random.RandomState(110 + hw)
    x = _bf16(rng, dev, n, hw, hw, c)
    w = _bf16(rng, dev, 3, 3, c, cout, scale=1 / np.sqrt(9 * c))
    b = torch.as_tensor(rng.randn(cout) * 0.1, dtype=torch.float32,
                        device=dev)
    ho = (hw - 1) // stride + 1
    out = torch.empty((n, ho, ho, cout), dtype=torch.bfloat16, device=dev)
    got = BK._gemm(out, [(x, w.reshape(9 * c, cout), stride, 3)], b,
                   BK._RELU_BF16)
    want = torch.relu(BK._conv3x3(x.float(), w.float(), stride) + b)
    _bf16_close(got, want.bfloat16())


@pytest.mark.parametrize('n,hw,cm,cin,cout,stride,x_i8', [
    (2, 9, 64, 64, 256, 2, True), (1, 7, 128, 256, 512, 1, True),
    (3, 5, 64, 96, 128, 1, False)])
def test_gemm_kpacked_projection(dev, n, hw, cm, cin, cout, stride, x_i8):
    """[h2 | x_s] . [[w3], [wd]] + b3 + bd in one f32 sum, x int8 (widened
    in shared memory) or bf16; the v2 epilogue, within one int8 LSB."""
    from instaorder_tpu_torch.ops import bottleneck_kernels as BK
    rng = np.random.RandomState(120 + cin)
    ho = (hw - 1) // stride + 1
    h2 = torch.as_tensor(rng.randint(0, 9, (n, ho, ho, cm)), device=dev,
                         dtype=torch.bfloat16)
    x = torch.as_tensor(rng.randint(0, 128, (n, hw, hw, cin)), device=dev)
    x = x.to(torch.int8 if x_i8 else torch.bfloat16)
    w3 = _bf16(rng, dev, cm, cout, scale=8 / np.sqrt(cm))
    wd = _bf16(rng, dev, cin, cout, scale=1 / np.sqrt(cin))
    b3, bd = (torch.as_tensor(rng.randn(cout) * 5, dtype=torch.float32,
                              device=dev) for _ in range(2))
    out = torch.empty((n, ho, ho, cout), dtype=torch.int8, device=dev)
    got = BK._gemm(out, [(h2, w3, 1, 1), (x, wd, stride, 1)], b3,
                   BK._Q8_INT8, bias2=bd)
    xs = x.float()[:, ::stride, ::stride]
    y = torch.cat([h2.float(), xs], -1) @ torch.cat([w3.float(), wd.float()])
    want = torch.clamp(torch.round(y + b3 + bd), 0, 127).to(torch.int8)
    _close(got, want)
    assert float(((want > 0) & (want < 127)).float().mean()) > 0.05


def test_gemm_kpacked_projection_refuses_straddle(dev):
    """A K-packed first segment that is not a whole number of K steps
    (K = 96) is refused before the launch."""
    from instaorder_tpu_torch.ops import bottleneck_kernels as BK
    rng = np.random.RandomState(130)
    h2 = _bf16(rng, dev, 1, 4, 4, 96)
    x = _bf16(rng, dev, 1, 4, 4, 64)
    b = torch.zeros(128, dtype=torch.float32, device=dev)
    out = torch.empty((1, 4, 4, 128), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match='straddle'):
        BK._gemm(out, [(h2, _bf16(rng, dev, 96, 128), 1, 1),
                       (x, _bf16(rng, dev, 64, 128), 1, 1)], b, BK._Q8_INT8,
                 bias2=b)


@pytest.mark.parametrize('n,hw,c,cout,ksize,stride', [
    (1, 7, 64, 64, 1, 1),      # K = 64: half of one 128-deep step
    (2, 9, 64, 64, 3, 2),      # stride-2 3x3 at the edges, 128 x 64
    (3, 10, 128, 256, 3, 1),
    (2, 5, 512, 2048, 1, 1)])  # Cout = 2048
def test_gemm_s8_tiles(dev, n, hw, c, cout, ksize, stride):
    from instaorder_tpu_torch.ops import gemm_layout as GL
    from instaorder_tpu_torch.ops import int8_kernels as IK
    rng = np.random.RandomState(140 + c + ksize)
    x = torch.as_tensor(rng.randint(0, 128, (n, hw, hw, c)), device=dev,
                        dtype=torch.int8)
    shape = (ksize, ksize, c, cout)
    w, m, b = _i8_conv(rng, dev, ksize * ksize * c, cout, shape)
    ho = (hw - 1) // stride + 1
    out = torch.empty((n, ho, ho, cout), dtype=torch.int8, device=dev)
    got = IK._gemm(out, [(x, GL.kmajor(w), m, b, stride, ksize)],
                   IK._RQ8)
    want = IK.requant(IK.conv_int8(x, w, stride, ksize // 2), m, b)
    _exact(got, want)


@pytest.mark.parametrize('n,hw,cm,cin,cout,stride', [
    (2, 9, 64, 64, 256, 2), (1, 6, 512, 1024, 2048, 2),
    (3, 5, 128, 256, 512, 1)])
def test_gemm_s8_two_segment_projection(dev, n, hw, cm, cin, cout, stride):
    """The projection segment finished into f32 first, then h2 . w3: the
    sum (acc3 m3 + b3) + (accd md + bd), equal on every value."""
    from instaorder_tpu_torch.ops import gemm_layout as GL
    from instaorder_tpu_torch.ops import int8_kernels as IK
    rng = np.random.RandomState(150 + cin)
    ho = (hw - 1) // stride + 1
    h2 = torch.as_tensor(rng.randint(0, 128, (n, ho, ho, cm)), device=dev,
                         dtype=torch.int8)
    x = torch.as_tensor(rng.randint(0, 128, (n, hw, hw, cin)), device=dev,
                        dtype=torch.int8)
    w3, m3, b3 = _i8_conv(rng, dev, cm, cout, (cm, cout))
    wd, md, bd = _i8_conv(rng, dev, cin, cout, (cin, cout))
    w3k, wdk = GL.kmajor(w3), GL.kmajor(wd)
    out = torch.empty((n, ho, ho, cout), dtype=torch.int8, device=dev)
    got = IK._gemm(out, [(h2, w3k, m3, b3, 1, 1),
                         (x, wdk, md, bd, stride, 1)], IK._PROJECTION)
    y = IK.conv_int8(h2, w3[None, None]).float().mul_(m3).add_(b3)
    yd = IK.conv_int8(x, wd[None, None], stride).float().mul_(md).add_(bd)
    _exact(got, y.add_(yd).round_().clamp_(0, 127).to(torch.int8))


@pytest.mark.parametrize('passes', [1, 3])
@pytest.mark.parametrize('out_size', [72, 256, 300])
def test_prep_f32_out_adversarial_rois_exact(dev, out_size, passes):
    """Row 1'', the 5-channel prep's f32-output mode, equal to its plain
    version run on the CPU on every value (one launch a call; odd image
    sizes, adversarial crops, 300: two column tiles), and its values
    rounded to bf16 equal to the bf16 mode's."""
    from instaorder_tpu_torch import serving
    from instaorder_tpu_torch.ops import prep_kernels as PK
    images, masks, _ = serving.synthetic_scenes(2, 131, 203, 4, seed=12)
    sc = serving.upload_scenes(images, masks, np.zeros((2, 4, 4)),
                               device=dev)
    rng = np.random.RandomState(out_size + 10 * passes)
    pidx = torch.as_tensor(rng.randint(0, 4, (9, 2)), dtype=torch.int32,
                           device=dev)
    rois = _adversarial_rois(out_size, 203).to(dev)
    host = [t.cpu() for t in (sc[0], sc[1], pidx, rois)]
    before = PK.fused_prep_pairs.launches
    got = PK.fused_prep_pairs(sc[0], sc[1], pidx, rois, out_size=out_size,
                              passes=passes, out_dtype=torch.float32)
    assert PK.fused_prep_pairs.launches == before + 1
    want = PK.fused_prep_pairs_plain(*host, out_size=out_size, passes=passes,
                                     out_dtype=torch.float32)
    assert got.dtype == torch.float32
    assert got.shape == want.shape == (18, out_size, out_size, 5)
    n = int((got.cpu() != want).sum())
    assert n == 0, f'{n} differing values'
    b16 = PK.fused_prep_pairs(sc[0], sc[1], pidx, rois, out_size=out_size,
                              passes=passes)
    assert torch.equal(got.bfloat16(), b16)


def _pred_scene(seed, n=5, h=96, w=128):
    rng = np.random.RandomState(seed)
    image = rng.randint(0, 255, (h, w, 3)).astype(np.float32)
    masks = np.zeros((n, h, w), np.float32)
    bboxes = np.zeros((n, 4), np.float32)
    for k in range(n):
        y0, x0 = rng.randint(0, h - 40), rng.randint(0, w - 40)
        hh, ww = rng.randint(15, 40), rng.randint(15, 40)
        masks[k, y0:y0 + hh, x0:x0 + ww] = 1
        bboxes[k] = [x0, y0, ww, hh]
    return image, masks, bboxes


@pytest.mark.parametrize('factory', ['v2', 'v2-f32', 'int8c', 'bf16', 'f32'])
def test_predictor_factories_card_vs_cpu(dev, factory):
    """Each factory's infer_occ_order on the card against the same
    predictor moved to the CPU (the plain versions), on one small scene
    (ResNet-50 widths, layers (1, 1, 1, 1), input 64, the head scaled so
    that decisions are sure): f32 and int8c logits within 1e-5 of max
    |logit| and matrices equal; bf16 and v2 logits within 2% and the
    matrix cells equal where the CPU's probability is more than 1e-2
    from 0.5. The kernels of the route launch."""
    from instaorder_tpu_torch.eval import pipeline as TPL
    from instaorder_tpu_torch.models import resnet
    from instaorder_tpu_torch.ops import prep_kernels as PK
    gen = torch.Generator().manual_seed(0)
    params, stats, cfg = resnet.init(gen, arch='resnet50', in_channels=5,
                                     num_classes=2, layers_override=(1,) * 4)
    params['fc'] = {k: v * 100.0 for k, v in params['fc'].items()}
    scene = _pred_scene(3)
    kw = dict(input_size=64, prep_impl='pallas5', device=dev)
    b16 = dict(kw, prep_dtype=torch.bfloat16)
    calib = [TPL.OrderPredictor(resnet.apply, cfg, params, stats,
                                'InstaOrderNet_o', input_size=64,
                                device='cpu')._build_batch(
        torch.from_numpy(scene[0]), torch.from_numpy(scene[1]),
        torch.from_numpy(scene[2]), np.array([[0, 1], [1, 2], [2, 3]],
                                             np.int32))[0]]
    make, bar = {
        'v2': (lambda: TPL.make_v2_predictor(params, stats, cfg,
                                             'InstaOrderNet_o', calib,
                                             prep_passes=1, **b16), 0.02),
        # the v2 model at compute_dtype=f32 with its q8 stem: the f32
        # modes of the v2 kernels
        'v2-f32': (lambda: TPL.make_v2_predictor(
            params, stats, cfg, 'InstaOrderNet_o', calib,
            use_pallas=('hwnc', 'down2', 'hwncs1d', 'dirpack', 'stem'),
            compute_dtype=torch.float32, **kw), 0.02),
        'int8c': (lambda: TPL.make_int8_predictor(
            params, stats, cfg, 'InstaOrderNet_o', calib, **b16), 1e-5),
        'bf16': (lambda: TPL.make_folded_predictor(
            params, stats, cfg, 'InstaOrderNet_o', dtype=torch.bfloat16,
            use_pallas=('identity', 'down', 'stem'), **b16), 0.02),
        'f32': (lambda: TPL.make_folded_predictor(
            params, stats, cfg, 'InstaOrderNet_o', **kw), 1e-5),
    }[factory]
    pred = make()
    cpu = pred.to('cpu')
    before = PK.fused_prep_pairs.launches
    pidx, valid, g1, g2, _ = pred.pair_outputs(*scene)
    assert PK.fused_prep_pairs.launches == before + 1
    _, _, w1, w2, _ = cpu.pair_outputs(*scene)
    for g, w in ((g1, w1), (g2, w2)):
        scale = float(w.abs().max())
        assert scale > 0.1
        assert float((g.cpu() - w).abs().max()) <= bar * scale
    got = pred.infer_occ_order(*scene)
    want = cpu.infer_occ_order(*scene)
    if bar == 1e-5:
        np.testing.assert_array_equal(got, want)
        return
    s1, s2 = torch.sigmoid(w1), torch.sigmoid(w2)
    probs = ((s1[:, 1] + s2[:, 0]) / 2, (s1[:, 0] + s2[:, 1]) / 2)
    n = 0
    for k in np.flatnonzero(valid.cpu().numpy()):
        i, j = pidx[k]
        for (a, b), p in (((i, j), probs[0][k]), ((j, i), probs[1][k])):
            if abs(float(p) - 0.5) > 1e-2:
                assert got[a, b] == want[a, b], (a, b)
                n += 1
    assert n > 0


def test_f32_predictor_refuses_card_kernels(dev):
    """The f32 model (dtype=None) runs the kernels' f32 modes on the card:
    each feature set launches its kernels, and the logits stay within
    1e-5 of max |logit| of the same predictor on the CPU, matrices
    equal; use_pallas=False launches none."""
    from instaorder_tpu_torch.eval import pipeline as TPL
    from instaorder_tpu_torch.models import resnet
    from instaorder_tpu_torch.ops import bottleneck_bf16_kernels as B16
    from instaorder_tpu_torch.ops import stem_kernels as SK
    gen = torch.Generator().manual_seed(0)
    params, stats, cfg = resnet.init(gen, arch='resnet50', in_channels=5,
                                     num_classes=2, layers_override=(1,) * 4)
    params['fc'] = {k: v * 100.0 for k, v in params['fc'].items()}
    scene = _pred_scene(4)
    wrappers = (B16.fused_bottleneck, B16.fused_bottleneck_down, SK.fused_stem)
    for use_pallas, want in ((False, (0, 0, 0)), (True, (0, 0, 0)),
                             (('stem',), (0, 0, 1)),
                             (('identity', 'down', 'stem'), (0, 3, 1))):
        pred = TPL.make_folded_predictor(params, stats, cfg,
                                         'InstaOrderNet_o', input_size=64,
                                         use_pallas=use_pallas, device=dev)
        assert pred.device.type == 'cuda'
        assert pred.params['conv1']['wk'].dtype == torch.float32
        assert all(bp['wk'][0].shape[0] == 2
                   for li in range(4) for bp in pred.params[f'layer{li + 1}'])
        before = [w.launches for w in wrappers]
        _, _, g1, g2, _ = pred.pair_outputs(*scene)
        assert tuple(w.launches - b for w, b in zip(wrappers, before)) == want
        _, _, w1, w2, _ = pred.to('cpu').pair_outputs(*scene)
        for g, w in ((g1, w1), (g2, w2)):
            scale = float(w.abs().max())
            assert scale > 0.1
            assert float((g.cpu() - w).abs().max()) <= 1e-5 * scale
        np.testing.assert_array_equal(pred.infer_occ_order(*scene),
                                      pred.to('cpu').infer_occ_order(*scene))


@pytest.mark.parametrize('precision', ['default', 'high', 'highest'])
@pytest.mark.parametrize('stage1', [None, torch.bfloat16])
def test_einsum_prep_precisions_card_vs_cpu(dev, precision, stage1):
    """The einsum prep at each --prep-precision (the bf16 passes on the
    tensor cores, torch.bmm with an f32 output) against the same route
    on the CPU: masks exact, RGB within one uint8 LSB on under 1% of
    pixels (sums of exact products in another order)."""
    from instaorder_tpu_torch import serving
    from instaorder_tpu_torch.ops import pairs as P
    images, masks, bboxes = serving.synthetic_scenes(2, 131, 203, 4,
                                                     seed=13)
    sc = serving.upload_scenes(images, masks, bboxes, device=dev)
    pidx = torch.as_tensor(P.all_pair_indices(4)[0], device=dev)
    rois = P.pair_rois(sc[2], pidx)
    args = (sc[0], sc[1], pidx, rois)
    got = P.build_pair_batches_matmul(*args, out_size=72,
                                      precision=precision,
                                      stage1_dtype=stage1)
    want = P.build_pair_batches_matmul(*[t.cpu() for t in args],
                                       out_size=72, precision=precision,
                                       stage1_dtype=stage1)
    got = got.cpu()
    assert torch.equal(got[..., :2], want[..., :2])
    d = (got[..., 2:] - want[..., 2:]).abs()
    assert float(d.max()) <= 1.0 / (255 * 0.224) + 1e-6
    assert float((d > 1e-5).float().mean()) < 0.01


# ---------------------------------------------------------------------------
# the f32 modes (the folded model at f32): the implicit-GEMM kernel's f32
# mode (csrc/bottleneck_f32.cu) one launch at a time and as blocks, the
# f32 stem and the RGB prep's f32 output, each against its plain version
# on the card with TF32 off (resolve_device) within the f32 bar
# ---------------------------------------------------------------------------


def _f32(rng, dev, *shape, scale=1.0):
    return torch.as_tensor(rng.randn(*shape) * scale, dtype=torch.float32,
                           device=dev)


@pytest.mark.parametrize('n,hw,cin,cout,ksize,stride', [
    (1, 7, 64, 64, 1, 1),        # one K step pair, M = 49, 128 x 64 tile
    (2, 9, 96, 128, 1, 1),       # K = 96: three steps, M = 162
    (2, 5, 512, 2048, 1, 1),     # Cout = 2048
    (2, 9, 64, 64, 3, 2),        # the stride-2 3x3 at the edges
    (3, 6, 128, 128, 3, 1),
    (2, 8, 512, 512, 3, 1)])     # layer4's 3x3: K = 4,608, 144 steps
def test_gemm_f32_tiles(dev, n, hw, cin, cout, ksize, stride):
    from instaorder_tpu_torch.ops import bottleneck_kernels as BK
    from instaorder_tpu_torch.ops.gemm_layout import split_kmajor_f32
    rng = np.random.RandomState(200 + cin + ksize)
    x = _f32(rng, dev, n, hw, hw, cin)
    w = _f32(rng, dev, ksize, ksize, cin, cout,
             scale=1 / np.sqrt(ksize * ksize * cin))
    b = _f32(rng, dev, cout, scale=0.1)
    ho = (hw - 1) // stride + 1
    out = torch.empty((n, ho, ho, cout), dtype=torch.float32, device=dev)
    got = BK._gemm(out, [(x, split_kmajor_f32(w), stride, ksize)], b,
                   BK._RELU_F32)
    if ksize == 1:
        want = torch.relu(x[:, ::stride, ::stride] @ w[0, 0] + b)
    else:
        want = torch.relu(BK._conv3x3(x, w, stride) + b)
    _f32_close(got, want)


@pytest.mark.parametrize('n,hw,cm,cin,cout,stride', [
    (2, 9, 64, 64, 256, 2), (1, 7, 128, 256, 512, 1), (3, 5, 64, 96, 128, 1)])
def test_gemm_f32_kpacked_projection(dev, n, hw, cm, cin, cout, stride):
    """relu([h2 | x_s] . [[w3], [wd]] + b3 + bd) in one f32 sum."""
    from instaorder_tpu_torch.ops import bottleneck_kernels as BK
    from instaorder_tpu_torch.ops.gemm_layout import split_kmajor_f32 as sk
    rng = np.random.RandomState(220 + cin)
    ho = (hw - 1) // stride + 1
    h2 = torch.relu(_f32(rng, dev, n, ho, ho, cm))
    x = _f32(rng, dev, n, hw, hw, cin)
    w3 = _f32(rng, dev, cm, cout, scale=1 / np.sqrt(cm))
    wd = _f32(rng, dev, cin, cout, scale=1 / np.sqrt(cin))
    b3, bd = _f32(rng, dev, cout, scale=0.1), _f32(rng, dev, cout, scale=0.1)
    out = torch.empty((n, ho, ho, cout), dtype=torch.float32, device=dev)
    got = BK._gemm(out, [(h2, sk(w3), 1, 1), (x, sk(wd), stride, 1)], b3,
                   BK._RES_RELU_F32, bias2=bd)
    want = torch.relu(h2 @ w3 + b3 + (x[:, ::stride, ::stride] @ wd + bd))
    _f32_close(got, want)


def test_gemm_f32_refuses_mixed_types(dev):
    """An f32 output with bf16 operands (or a bf16 residual) is refused
    before the launch: the f32 mode never rounds. So are f32 weights in
    any layout but the split K-major one."""
    from instaorder_tpu_torch.ops import bottleneck_kernels as BK
    from instaorder_tpu_torch.ops.gemm_layout import split_kmajor_f32
    rng = np.random.RandomState(230)
    x = _f32(rng, dev, 1, 4, 4, 64)
    w = _f32(rng, dev, 64, 64)
    wk = split_kmajor_f32(w)
    b = _f32(rng, dev, 64)
    out = torch.empty((1, 4, 4, 64), dtype=torch.float32, device=dev)
    with pytest.raises(ValueError, match='float32'):
        BK._gemm(out, [(x.bfloat16(), wk, 1, 1)], b, BK._RELU_F32)
    with pytest.raises(ValueError, match='weight'):
        BK._gemm(out, [(x, wk.bfloat16(), 1, 1)], b, BK._RELU_F32)
    with pytest.raises(ValueError, match='split K-major'):
        BK._gemm(out, [(x, w, 1, 1)], b, BK._RELU_F32)
    with pytest.raises(ValueError, match='residual'):
        BK._gemm(out, [(x, wk, 1, 1)], b, BK._RES_RELU_F32,
                 res=x.bfloat16(), r=1.0)


def test_f32_wrappers_need_split_weights(dev):
    """A CUDA call at f32 without the split K-major weights raises (no
    split on the fly, no fallback), for each wrapper family; with them it
    launches."""
    from instaorder_tpu_torch.ops import bottleneck_bf16_kernels as B16
    from instaorder_tpu_torch.ops import bottleneck_kernels as BK
    rng = np.random.RandomState(235)
    x = _f32(rng, dev, 1, 8, 8, 64)
    p = [a.float() for a in _bf16_blk(rng, dev, 64, 64, 64, False)]
    pd = [a.float() for a in _bf16_blk(rng, dev, 64, 64, 128, True)]
    x8 = torch.as_tensor(rng.randint(0, 128, (1, 8, 8, 64)), device=dev,
                         dtype=torch.int8)
    calls = [lambda **k: B16.fused_bottleneck(x, *p, **k),
             lambda **k: B16.fused_bottleneck_hwnc(x, *p, **k),
             lambda **k: B16.fused_bottleneck_down(x, *pd, stride=2, **k),
             lambda **k: BK.fused_bottleneck_i8v2(x8, *p, 0.5, **k),
             lambda **k: BK.fused_bottleneck_i8v2_down_s2(x8, *pd, **k)]
    wks = [_wk32(p), _wk32(p), _wk32(pd), _wk32(p), _wk32(pd)]
    for call, wk in zip(calls, wks):
        with pytest.raises(ValueError, match='wk='):
            call()
        with pytest.raises(ValueError, match='wk='):
            call(wk=wk[:2])
        assert call(wk=wk).shape[0] == 1
    for fn in (B16.fused_bottleneck_stage, B16.fused_bottleneck_stage_stream):
        with pytest.raises(ValueError, match='wk='):
            fn(x, [p])


@pytest.mark.parametrize('cin,cout', [(64, 64), (256, 128)])
def test_gemm_f32_int8_segment_equals_f32_integers(dev, cin, cout):
    """An int8 A segment takes two products (its lo is 0); the same
    integers held in f32 take the f32 segment's three, whose lo . hi
    product is 0: the two launches agree on every value, alone and as
    the K-packed projection's second segment."""
    from instaorder_tpu_torch.ops import bottleneck_kernels as BK
    from instaorder_tpu_torch.ops.gemm_layout import split_kmajor_f32 as sk
    rng = np.random.RandomState(240 + cin)
    x8 = torch.as_tensor(rng.randint(0, 128, (2, 9, 9, cin)), device=dev,
                         dtype=torch.int8)
    h2 = torch.relu(_f32(rng, dev, 2, 9, 9, 64))
    w, w3 = _f32(rng, dev, cin, cout, scale=0.1), _f32(rng, dev, 64, cout)
    b = _f32(rng, dev, cout)
    outs = []
    for x in (x8, x8.float()):
        o1 = BK._gemm(torch.empty((2, 9, 9, cout), device=dev),
                      [(x, sk(w), 1, 1)], b, BK._RELU_F32)
        o2 = BK._gemm(torch.empty((2, 9, 9, cout), device=dev),
                      [(h2, sk(w3), 1, 1), (x, sk(w), 1, 1)], b,
                      BK._Q8_F32, bias2=b)
        outs.append((o1, o2))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    _f32_close(outs[0][0], torch.relu(x8.float() @ w + b))


@pytest.mark.parametrize('n,hw', [(1, 7), (3, 10), (2, 13)])
def test_f32_identity_kernel_ragged(dev, n, hw):
    from instaorder_tpu_torch.ops import bottleneck_bf16_kernels as B16
    rng = np.random.RandomState(240 + n)
    x = _f32(rng, dev, n, hw, hw, 256)
    p = [a.float() for a in _bf16_blk(rng, dev, 256, 64, 256, False)]
    before = B16.fused_bottleneck.launches
    got = B16.fused_bottleneck(x, *p, wk=_wk32(p))
    _launched(B16.fused_bottleneck, before)
    _f32_close(got, B16.fused_bottleneck_plain(x, *p))


@pytest.mark.parametrize('stride,n,hw', [(1, 3, 9), (2, 1, 9), (2, 3, 14)])
def test_f32_down_kernel_ragged(dev, stride, n, hw):
    from instaorder_tpu_torch.ops import bottleneck_bf16_kernels as B16
    rng = np.random.RandomState(250 + hw)
    x = _f32(rng, dev, n, hw, hw, 64)
    p = [a.float() for a in _bf16_blk(rng, dev, 64, 64, 128, True)]
    before = B16.fused_bottleneck_down.launches
    got = B16.fused_bottleneck_down(x, *p, stride=stride, wk=_wk32(p))
    _launched(B16.fused_bottleneck_down, before)
    assert got.shape[1] == (hw - 1) // stride + 1
    _f32_close(got, B16.fused_bottleneck_down_plain(x, *p, stride=stride))


@pytest.mark.parametrize('n,hw,c,cm,k', [(2, 9, 256, 64, 2),
                                         (1, 13, 512, 128, 3)])
def test_f32_stage_and_hwnc_kernels(dev, n, hw, c, cm, k):
    """Kernels 11, 12 (k identity blocks; the bar per chained block) and
    14 at f32."""
    from instaorder_tpu_torch.ops import bottleneck_bf16_kernels as B16
    rng = np.random.RandomState(260 + hw)
    x = _f32(rng, dev, n, hw, hw, c)
    blocks = [[a.float() for a in _bf16_blk(rng, dev, c, cm, c, False)]
              for _ in range(k)]
    want = B16.fused_bottleneck_stage_plain(x, blocks)
    wks = [_wk32(p) for p in blocks]
    for fn in (B16.fused_bottleneck_stage, B16.fused_bottleneck_stage_stream):
        before = fn.launches
        got = fn(x, blocks, wk=wks)
        _launched(fn, before)
        _f32_close(got, want, 2e-5 * k)
    before = B16.fused_bottleneck_hwnc.launches
    got = B16.fused_bottleneck_hwnc(x, *blocks[0], wk=wks[0])
    _launched(B16.fused_bottleneck_hwnc, before)
    _f32_close(got, B16.fused_bottleneck_hwnc_plain(x, *blocks[0]))


@pytest.mark.parametrize('n,hw,cout,c', [
    (1, 36, 64, 5), (3, 50, 128, 5), (2, 30, 128, 3), (9, 256, 128, 5),
    (1, 46, 64, 1), (2, 34, 128, 2), (1, 38, 64, 4)])
def test_f32_stem_kernel(dev, n, hw, cout, c):
    """Pooled sizes 9, 13, 8, 64, 12, 9 and 10: strips that do not divide
    the output, odd conv sizes, both channel halves, the serving shape
    with persistent CTAs walking several items, and C = 1 to 4 (each its
    own count of skipped zero k8 steps)."""
    from instaorder_tpu_torch.ops import stem_kernels as SK
    rng = np.random.RandomState(270 + hw)
    x = _f32(rng, dev, n, hw, hw, c)
    w = _f32(rng, dev, 7, 7, c, cout, scale=1 / np.sqrt(49 * c))
    b = _f32(rng, dev, cout, scale=0.1)
    before = SK.fused_stem.launches
    got = SK.fused_stem(x, w, b, wk=SK.stem_kernel_weights(w))
    assert SK.fused_stem.launches == before + 1
    ho = ((hw - 1) // 2) // 2 + 1
    assert tuple(got.shape) == (n, ho, ho, cout)
    _f32_close(got, SK.fused_stem_plain(x, w, b), 1e-5)


def test_f32_stem_wide_image(dev):
    """A 480 x 640 input (the 'orig' predictor mode): three column tiles
    of pooled columns."""
    from instaorder_tpu_torch.ops import stem_kernels as SK
    rng = np.random.RandomState(280)
    x = _f32(rng, dev, 2, 480, 640, 5)
    w = _f32(rng, dev, 7, 7, 5, 64, scale=1 / np.sqrt(245))
    b = _f32(rng, dev, 64, scale=0.1)
    got = SK.fused_stem(x, w, b, wk=SK.stem_kernel_weights(w))
    assert tuple(got.shape) == (2, 120, 160, 64)
    _f32_close(got, SK.fused_stem_plain(x, w, b), 1e-5)


@pytest.mark.parametrize('passes,normalize', [(1, True), (3, True),
                                              (3, False)])
def test_prep_rgb_f32_out_odd_sizes(dev, passes, normalize):
    """Kernel 5's f32-output mode equal to its plain version run on the
    CPU on every value (the card's PyTorch divides by a Python scalar as
    a multiply by the reciprocal), and to the bf16 mode once rounded."""
    from instaorder_tpu_torch import serving
    from instaorder_tpu_torch.ops import pairs as P
    from instaorder_tpu_torch.ops import prep_kernels as PK
    images, masks, bboxes = serving.synthetic_scenes(3, 131, 203, 4, seed=6)
    sc = serving.upload_scenes(images, masks, bboxes, device=dev)
    pidx = torch.as_tensor(P.all_pair_indices(4)[0], device=dev)
    rois = P.pair_rois(sc[2], pidx).contiguous()
    rois[1, 2] = torch.tensor([-40.0, -30.0, 260.0, 260.0])  # off-image
    before = PK.fused_prep_rgb.launches
    got = PK.fused_prep_rgb(sc[0], rois, out_size=72, normalize=normalize,
                            passes=passes, out_dtype=torch.float32)
    assert PK.fused_prep_rgb.launches == before + 1
    assert got.dtype == torch.float32
    want = PK.fused_prep_rgb_plain(sc[0].cpu(), rois.cpu(), out_size=72,
                                   normalize=normalize, passes=passes,
                                   out_dtype=torch.float32)
    n = int((got.cpu() != want).sum())
    assert n == 0, f'{n} differing values'
    b16 = PK.fused_prep_rgb(sc[0], rois, out_size=72, normalize=normalize,
                            passes=passes)
    assert torch.equal(got.bfloat16(), b16)


# ---------------------------------------------------------------------------
# the v2 model at compute_dtype=f32: the f32 GEMM with int8 A segments, an
# int8 residual and the v2 epilogues (int8 or f32 out), each v2 wrapper
# given f32 weights, and the f32 q8 stem, against their plain versions
# (the v2 bars: one int8 LSB on under 1% a block, k LSB over k chained)
# ---------------------------------------------------------------------------


def _blk32(rng, dev, cin, cm, cout, down):
    return [a.float() for a in _blk(rng, dev, cin, cm, cout, down)]


@pytest.mark.parametrize('n,hw,cin,cout,out_int8', [
    (3, 7, 64, 64, True),        # M = 147, one K step pair, 128 x 64
    (2, 10, 96, 256, False),     # K = 96: three int8 steps, f32 out
    (1, 5, 512, 2048, True)])    # Cout = 2048, M = 25
def test_gemm_f32_int8_segment(dev, n, hw, cin, cout, out_int8):
    """One launch on an int8 x (32 raw bytes a K step, widened to f32):
    relu(x . w + b) in f32 within 2e-5, and the v2 epilogue clip(rint(x
    . w + b + r * res), 0, 127) with an int8 residual, int8 or f32 out."""
    from instaorder_tpu_torch.ops import bottleneck_kernels as BK
    from instaorder_tpu_torch.ops.gemm_layout import split_kmajor_f32
    rng = np.random.RandomState(300 + cin)
    x = torch.as_tensor(rng.randint(-128, 128, (n, hw, hw, cin)), device=dev,
                        dtype=torch.int8)
    w = _f32(rng, dev, cin, cout, scale=0.3 / np.sqrt(cin))
    b = _f32(rng, dev, cout, scale=5.0)
    wk = split_kmajor_f32(w)
    out = torch.empty((n, hw, hw, cout), dtype=torch.float32, device=dev)
    got = BK._gemm(out, [(x, wk, 1, 1)], b, BK._RELU_F32)
    _f32_close(got, torch.relu(x.float() @ w + b))
    res = torch.as_tensor(rng.randint(0, 128, (n, hw, hw, cout)), device=dev,
                          dtype=torch.int8)
    out = torch.empty((n, hw, hw, cout), device=dev,
                      dtype=torch.int8 if out_int8 else torch.float32)
    got = BK._gemm(out, [(x, wk, 1, 1)], b,
                   BK._Q8_INT8_F32 if out_int8 else BK._Q8_F32, res=res,
                   r=0.43)
    y = x.float() @ w + b + res.float() * 0.43
    want = torch.clamp(torch.round(y), 0, 127).to(out.dtype)
    _close(got, want)
    assert float(((want > 0) & (want < 127)).float().mean()) > 0.05


@pytest.mark.parametrize('n,hw,cm,cin,cout,stride', [
    (2, 9, 64, 64, 256, 2), (1, 7, 128, 256, 512, 1), (3, 5, 64, 96, 128, 1)])
def test_gemm_f32_kpacked_int8_second_segment(dev, n, hw, cm, cin, cout,
                                              stride):
    """The K-packed projection [h2 | x_s] . [[w3], [wd]] + b3 + bd with an
    f32 h2 and an int8 x (stride 2 at the edges, K = 96 in three steps)
    in one f32 sum, the v2 epilogue within one int8 LSB; int8 and f32
    out hold the same integers."""
    from instaorder_tpu_torch.ops import bottleneck_kernels as BK
    from instaorder_tpu_torch.ops.gemm_layout import split_kmajor_f32 as sk
    rng = np.random.RandomState(320 + cin)
    ho = (hw - 1) // stride + 1
    h2 = torch.relu(_f32(rng, dev, n, ho, ho, cm))
    x = torch.as_tensor(rng.randint(0, 128, (n, hw, hw, cin)), device=dev,
                        dtype=torch.int8)
    w3 = _f32(rng, dev, cm, cout, scale=8 / np.sqrt(cm))
    wd = _f32(rng, dev, cin, cout, scale=1 / np.sqrt(cin))
    b3, bd = _f32(rng, dev, cout, scale=5.0), _f32(rng, dev, cout, scale=5.0)
    xs = x.float()[:, ::stride, ::stride]
    y = torch.cat([h2, xs], -1) @ torch.cat([w3, wd]) + b3 + bd
    want = torch.clamp(torch.round(y), 0, 127)
    outs = []
    for dt, mode in ((torch.int8, BK._Q8_INT8_F32),
                     (torch.float32, BK._Q8_F32)):
        out = torch.empty((n, ho, ho, cout), dtype=dt, device=dev)
        got = BK._gemm(out, [(h2, sk(w3), 1, 1), (x, sk(wd), stride, 1)],
                       b3, mode, bias2=bd)
        _close(got, want.to(dt))
        outs.append(got)
    assert torch.equal(outs[0].float(), outs[1])
    assert float(((want > 0) & (want < 127)).float().mean()) > 0.05


def test_gemm_f32_refuses_mismatched_v2_output(dev):
    """The f32 mode's int8 output goes with _Q8_INT8_F32 only, and a bf16
    A segment is refused before the launch."""
    from instaorder_tpu_torch.ops import bottleneck_kernels as BK
    from instaorder_tpu_torch.ops.gemm_layout import split_kmajor_f32
    rng = np.random.RandomState(330)
    x = torch.zeros((1, 4, 4, 64), dtype=torch.int8, device=dev)
    w, b = split_kmajor_f32(_f32(rng, dev, 64, 64)), _f32(rng, dev, 64)
    with pytest.raises(ValueError, match='epilogue mode'):
        BK._gemm(torch.empty((1, 4, 4, 64), dtype=torch.int8, device=dev),
                 [(x, w, 1, 1)], b, BK._Q8_F32)
    with pytest.raises(ValueError, match='epilogue mode'):
        BK._gemm(torch.empty((1, 4, 4, 64), dtype=torch.float32, device=dev),
                 [(x, w, 1, 1)], b, BK._Q8_INT8_F32)
    with pytest.raises(ValueError, match='int8 or float32'):
        BK._gemm(torch.empty((1, 4, 4, 64), dtype=torch.int8, device=dev),
                 [(x.bfloat16(), w, 1, 1)], b, BK._Q8_INT8_F32)


@pytest.mark.parametrize('n,hw,c,cm,in_dt,out_int8', [
    (3, 7, 64, 64, torch.int8, True), (2, 10, 256, 64, torch.float32, False),
    (1, 16, 512, 128, torch.int8, False)])
def test_v2_f32_identity_kernels(dev, n, hw, c, cm, in_dt, out_int8):
    """Kernels 4[f32] and 8[f32]: int8 x (or f32 holding the integers),
    the int8 residual r*x, int8 or f32 out; M = 147, 200, 256."""
    from instaorder_tpu_torch.ops import bottleneck_kernels as BK
    rng = np.random.RandomState(340 + hw)
    x = torch.as_tensor(rng.randint(0, 128, (n, hw, hw, c)),
                        device=dev).to(in_dt)
    p = _blk32(rng, dev, c, cm, c, False)
    want = BK.fused_bottleneck_i8v2_identity_plain(x, *p, 0.45,
                                                   out_int8=out_int8)
    assert want.dtype == (torch.int8 if out_int8 else torch.float32)
    for fn in (BK.fused_bottleneck_i8v2_identity, BK.fused_bottleneck_i8v2):
        before = fn.launches
        got = fn(x, *p, 0.45, out_int8=out_int8, wk=_wk32(p))
        _launched(fn, before)
        _close(got, want)


@pytest.mark.parametrize('hw,cin,cout', [(8, 64, 256), (9, 256, 512),
                                         (14, 512, 1024)])
def test_v2_f32_down_s2_kernel(dev, hw, cin, cout):
    """Kernel 3[f32]: the stride-2 3x3 and the stride-2 int8 projection
    segment at the bottom and right edges of even and odd planes."""
    from instaorder_tpu_torch.ops import bottleneck_kernels as BK
    rng = np.random.RandomState(350 + hw)
    x = torch.as_tensor(rng.randint(0, 128, (2, hw, hw, cin)), device=dev,
                        dtype=torch.int8)
    p = _blk32(rng, dev, cin, cout // 4, cout, True)
    before = BK.fused_bottleneck_i8v2_down_s2.launches
    got = BK.fused_bottleneck_i8v2_down_s2(x, *p, wk=_wk32(p))
    _launched(BK.fused_bottleneck_i8v2_down_s2, before)
    assert tuple(got.shape) == (2, (hw - 1) // 2 + 1, (hw - 1) // 2 + 1, cout)
    _close(got, BK.fused_bottleneck_i8v2_down_s2_plain(x, *p))


@pytest.mark.parametrize('n,hw,cin,cm,cout,out_int8', [
    (3, 9, 64, 64, 256, True), (2, 7, 512, 128, 512, False),
    (1, 12, 256, 64, 256, True)])
def test_v2_f32_stride1_projection_kernels(dev, n, hw, cin, cm, cout,
                                           out_int8):
    """Kernels 7[f32] and 9[f32]: the K-packed projection with the int8 x
    as its second segment."""
    from instaorder_tpu_torch.ops import bottleneck_kernels as BK
    rng = np.random.RandomState(360 + hw)
    x = torch.as_tensor(rng.randint(0, 128, (n, hw, hw, cin)), device=dev,
                        dtype=torch.int8)
    p = _blk32(rng, dev, cin, cm, cout, True)
    for fn, plain in ((BK.fused_bottleneck_down_i8v2_hwnc,
                       BK.fused_bottleneck_down_i8v2_hwnc_plain),
                      (BK.fused_bottleneck_down_i8v2,
                       BK.fused_bottleneck_down_i8v2_plain)):
        before = fn.launches
        got = fn(x, *p, out_int8=out_int8, wk=_wk32(p))
        _launched(fn, before)
        _close(got, plain(x, *p, out_int8=out_int8))


@pytest.mark.parametrize('kind', ['stage', 'hwncp', 'run'])
def test_v2_f32_stage_kernels(dev, kind):
    """Kernels 2[f32], 6[f32] (layer1: the projection then two identity
    blocks) and 2'[f32] (an identity run of two blocks, f32 out): within
    one LSB per chained block."""
    from instaorder_tpu_torch.ops import bottleneck_kernels as BK
    rng = np.random.RandomState(370 + len(kind))
    c = 256 if kind == 'run' else 64
    x = torch.as_tensor(rng.randint(0, 128, (3, 10, 10, c)), device=dev,
                        dtype=torch.int8)
    down = None if kind == 'run' else _blk32(rng, dev, 64, 64, 256, True)
    blocks = [_blk32(rng, dev, 256, 64, 256, False) for _ in range(2)]
    rs = [0.5, 0.7]
    o = kind != 'run'
    fn = (BK.fused_bottleneck_i8v2_hwncp_stage if kind == 'hwncp'
          else BK.fused_bottleneck_i8v2_stage)
    wks = [_wk32(p) for p in ([] if down is None else [down]) + blocks]
    before = fn.launches
    got = fn(x, down, blocks, rs, out_int8=o, wk=wks)
    _launched(fn, before)
    k = len(blocks) + (down is not None)
    _close(got, BK.fused_bottleneck_i8v2_stage_plain(x, down, blocks, rs,
                                                     out_int8=o),
           bar=k, share=0.01 * k)


@pytest.mark.parametrize('n,hw,cout', [(1, 36, 64), (3, 50, 128),
                                       (2, 30, 64), (9, 256, 128)])
def test_f32_q8_stem_kernel(dev, n, hw, cout):
    """Kernel 15'[f32]: the f32 stem with the q8 epilogue (pooled, then
    clip(rint(v), 0, 127) as int8), Cout 64 and 128, odd conv sizes and
    the serving shape, within one LSB on under 1% of outputs."""
    from instaorder_tpu_torch.ops import stem_kernels as SK
    rng = np.random.RandomState(380 + hw)
    x = _f32(rng, dev, n, hw, hw, 5)
    w = _f32(rng, dev, 7, 7, 5, cout, scale=30 / np.sqrt(245))
    b = _f32(rng, dev, cout, scale=3.0)
    before = SK.fused_stem.launches
    got = SK.fused_stem(x, w, b, q8=True, wk=SK.stem_kernel_weights(w))
    assert SK.fused_stem.launches == before + 1
    want = SK.fused_stem_plain(x, w, b, q8=True)
    ho = ((hw - 1) // 2) // 2 + 1
    assert tuple(got.shape) == (n, ho, ho, cout) and got.dtype == torch.int8
    _close(got, want)
    assert float(((want > 0) & (want < 127)).float().mean()) > 0.2


# ---------------------------------------------------------------------------
# a second card: every wrapper launches on the device of its tensors
# ---------------------------------------------------------------------------


def test_every_wrapper_on_a_second_card(dev):
    """Every kernel wrapper, in each of its modes (bf16, f32, int8, the
    stems' q8, s8 and f32 instantiations, both preps), on cuda:1 with
    cuda:0 the current device, against its plain version on cuda:1: the
    wrappers make the tensors' card current for each launch, and the
    kernels set their shared-memory attribute and grid cap per card
    (a process-wide flag, set by a launch on cuda:0 first, would leave
    the cuda:1 launch refused). Skipped with fewer than two cards."""
    from instaorder_tpu_torch.ops import bottleneck_bf16_kernels as B16
    from instaorder_tpu_torch.ops import bottleneck_kernels as BK
    from instaorder_tpu_torch.ops import int8_kernels as IK
    from instaorder_tpu_torch.ops import prep_kernels as PK
    from instaorder_tpu_torch.ops import stem_kernels as SK
    if torch.cuda.device_count() < 2:
        pytest.skip('needs two CUDA devices')
    wrappers = [PK.fused_prep_pairs, PK.fused_prep_rgb,
                BK.fused_bottleneck_i8v2_stage,
                BK.fused_bottleneck_i8v2_down_s2,
                BK.fused_bottleneck_i8v2_identity,
                BK.fused_bottleneck_i8v2_hwncp_stage,
                BK.fused_bottleneck_down_i8v2_hwnc, BK.fused_bottleneck_i8v2,
                BK.fused_bottleneck_down_i8v2, B16.fused_bottleneck,
                B16.fused_bottleneck_down, B16.fused_bottleneck_stage,
                B16.fused_bottleneck_stage_stream, B16.fused_bottleneck_hwnc,
                SK.fused_stem, SK.fused_stem_int8, IK.fused_bottleneck_int8,
                IK.fused_bottleneck_down_int8,
                IK.fused_bottleneck_int8_hwnc,
                IK.fused_bottleneck_down_int8_hwnc,
                IK.fused_bottleneck_down_s2_int8_hwnc]
    before = [w.launches for w in wrappers]
    # a launch on cuda:0 first, so that a per-process flag would be set
    test_stem_kernel_ragged(dev, 1, 36, 64, False, torch.bfloat16)
    test_identity_kernel_ragged(dev, 3, 7, torch.int8, True)
    torch.cuda.set_device(0)
    d1 = torch.device('cuda', 1)
    test_prep_kernel_odd_sizes(d1, 3)
    test_prep_rgb_kernel_odd_sizes(d1, 3, True)
    test_prep_f32_out_adversarial_rois_exact(d1, 72, 3)
    test_identity_kernel_ragged(d1, 3, 7, torch.int8, True)
    test_down_s2_kernel_ragged(d1, 9)
    test_stage_kernel(d1)
    test_i8v2_nhwc_identity_kernel(d1, 3, 7, 256, 64, torch.int8)
    test_stride1_projection_kernels(d1, 3, 9, 64, 64, 256, True)
    test_hwncp_stage_kernel(d1)
    test_bf16_identity_kernel_ragged(d1, 3, 10)
    test_bf16_down_kernel_ragged(d1, 2, 3, 14)
    test_bf16_stage_and_hwnc_kernels(d1, 2, 9, 256, 64, 2)
    for dt in (torch.bfloat16, torch.float32):
        test_stem_kernel_ragged(d1, 3, 50, 128, False, dt)
        test_stem_kernel_ragged(d1, 2, 30, 128, True, dt)
    test_f32_q8_stem_kernel(d1, 2, 30, 64)
    test_f32_stem_kernel(d1, 3, 50, 128, 5)
    test_int8_identity_kernel_exact(d1, 3, 7, 64, 64)
    test_int8_projection_kernel_exact(d1, 1, 3, 9, 64, 64, 256)
    test_int8_projection_kernel_exact(d1, 2, 2, 9, 256, 128, 512)
    test_int8_stem_kernel_exact(d1, 3, 50, 128)
    test_f32_identity_kernel_ragged(d1, 3, 10)
    test_f32_down_kernel_ragged(d1, 2, 3, 14)
    test_f32_stage_and_hwnc_kernels(d1, 2, 9, 256, 64, 2)
    test_v2_f32_identity_kernels(d1, 2, 10, 256, 64, torch.float32, False)
    for kind in ('stage', 'hwncp', 'run'):
        test_v2_f32_stage_kernels(d1, kind)
    torch.cuda.synchronize(d1)
    assert torch.cuda.current_device() == 0
    missed = [w.__name__ for w, b in zip(wrappers, before)
              if w.launches == b]
    assert not missed, missed
