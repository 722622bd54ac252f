"""The layout the card's stem kernels read (csrc/stem.cu), on the CPU.

The kernel runs the 7x7/2 stem conv as a 4x4 stride-1 conv over the
padded, chunk-planar 2x2 space-to-depth input (`stem_pack_plain`, which
the kernel's pack pass writes) against the relaid weights
(`stem_kernel_weights`), reading K in its own order. Here that input and
those weights go through a plain im2col product in the kernel's K order,
then the bias / relu (or the requant) and the pool, and must equal the
plain versions the card is held against: the int8c stem bit for bit (sums
in float64 are exact), the bf16 stem computed in f32 within 1e-5 of the
output scale (the same products summed in another order). Also: the
model-build relayout adds the kernel weights and leaves the JAX-layout
ones as they were.

The f32 stem runs 3xTF32 on the same s2d input (its pack holds the 4C
f32 channels as exactly C chunks) with split K-major weights that leave
out the k8 steps of zero weights; a model of its sums (three TF32
products a MAC, a fresh accumulator a K step whose adds round toward
zero) must equal the plain stem within its 1e-5 bar, and its fragment
ownership, bank map and shared-memory budget are checked against the
kernel's constants.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from instaorder_tpu_torch.models import folding as FO
from instaorder_tpu_torch.models import quantize as Q
from instaorder_tpu_torch.ops import gemm_layout
from instaorder_tpu_torch.ops import stem_kernels as SK
from instaorder_tpu_torch.ops.int8_kernels import requant
import torch_threads  # noqa: F401 (the suite's torch thread cap)

SIZES = [30, 36, 50, 64]


def _packed_conv(xs, wk, int8):
    """The conv as the kernel computes it: im2col rows of the packed
    input xs (N, Hs, J, Ws, CW) in the kernel's K order (tap row du, tap
    column pair dxp, chunk j, tap column 2 dxp + e, element), times wk
    ((K, Cout), or (Cout, K) for int8) -> (N, Hs - 3, Ws - 3, Cout) f64
    (int8) or f32."""
    n, hs, J, ws, cw = xs.shape
    hc, wc = hs - 3, ws - 3
    cols = [xs[:, du:du + hc, j, 2 * dxp + e:2 * dxp + e + wc, :]
            for du in range(4) for dxp in range(2) for j in range(J)
            for e in range(2)]
    a = torch.cat(cols, dim=-1)
    if int8:
        return a.double() @ wk.t().double()
    return a.float() @ wk.float()


def _pool(h):
    return F.max_pool2d(h.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)


@pytest.mark.parametrize('c', [3, 5])
@pytest.mark.parametrize('cout', [64, 128])
@pytest.mark.parametrize('hw', SIZES)
def test_packed_bf16_layout_equals_plain_stem(hw, cout, c):
    rng = np.random.RandomState(hw + cout + c)
    bf = lambda a: torch.as_tensor(a, dtype=torch.bfloat16).float()
    x = bf(rng.randn(2, hw, hw, c))
    w = bf(rng.randn(7, 7, c, cout) / np.sqrt(49 * c))
    b = torch.as_tensor(rng.randn(cout) * 0.1, dtype=torch.float32)
    # the bf16 layouts of the bf16 input and weights (f32 ones have the
    # f32 stem's own layouts), widened back to f32 for the product
    xs = SK.stem_pack_plain(x.bfloat16()).float()
    wk = SK.stem_kernel_weights(w.bfloat16()).float()
    assert tuple(xs.shape) == (2, hw // 2 + 3, 3, hw // 2 + 3, 8)
    assert tuple(wk.shape) == (384, cout)
    got = _pool(torch.relu(_packed_conv(xs, wk, False) + b))
    want = SK.fused_stem_plain(x, w, b)
    assert got.shape == want.shape
    scale = float(want.abs().max())
    assert scale > 0
    assert float((got - want).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize('c', [3, 5])
@pytest.mark.parametrize('cout', [64, 128])
@pytest.mark.parametrize('hw', SIZES)
def test_packed_int8_layout_equals_plain_stem(hw, cout, c):
    rng = np.random.RandomState(100 + hw + cout + c)
    x8 = torch.as_tensor(rng.randint(-127, 128, (2, hw, hw, c)),
                         dtype=torch.int8)
    w8 = torch.as_tensor(rng.randint(-127, 128, (7, 7, c, cout)),
                         dtype=torch.int8)
    m = torch.as_tensor(rng.uniform(0.5, 2.0, cout) / (127 * 49 * c),
                        dtype=torch.float32) * 40
    b = torch.as_tensor(rng.randn(cout) * 20, dtype=torch.float32)
    xs = SK.stem_pack_plain(x8)
    wk = SK.stem_kernel_weights(w8)
    assert xs.dtype == wk.dtype == torch.int8
    assert tuple(xs.shape) == (2, hw // 2 + 3, 2, hw // 2 + 3, 16)
    assert tuple(wk.shape) == (cout, 512)
    h = requant(_packed_conv(xs, wk, True).to(torch.int32), m, b)
    got = _pool(h.float()).to(torch.int8)
    want = SK.fused_stem_int8_plain(x8, w8, m, b)
    assert got.shape == want.shape
    assert torch.equal(got, want)
    live = float(((want > 0) & (want < 127)).float().mean())
    assert live > 0.05


def test_pack_is_the_padded_s2d_input():
    """The planar bf16 pack holds s2d_stem_input's channels in order,
    then zeros; the relaid weights hold s2d_conv1_w's taps, then
    zeros."""
    rng = np.random.RandomState(3)
    x = torch.as_tensor(rng.randn(1, 12, 10, 5), dtype=torch.bfloat16)
    xs = SK.stem_pack_plain(x)
    flat = xs.permute(0, 1, 3, 2, 4).reshape(1, 9, 8, 24)
    assert torch.equal(flat[..., :20], SK.s2d_stem_input(x))
    assert not flat[..., 20:].any()
    w = torch.as_tensor(rng.randn(7, 7, 5, 64), dtype=torch.bfloat16)
    wk = SK.stem_kernel_weights(w).reshape(4, 2, 3, 2, 8, 64)
    w2 = wk.permute(0, 1, 3, 2, 4, 5).reshape(4, 4, 24, 64)
    assert torch.equal(w2[:, :, :20], SK.s2d_conv1_w(w))
    assert not w2[:, :, 20:].any()


def _conv1(rng, int8):
    if int8:
        return {'w': torch.as_tensor(rng.randint(-127, 128, (7, 7, 5, 64)),
                                     dtype=torch.int8),
                'm': torch.as_tensor(rng.rand(64), dtype=torch.float32),
                'b': torch.as_tensor(rng.randn(64), dtype=torch.float32)}
    return {'w': torch.as_tensor(rng.randn(7, 7, 5, 64),
                                 dtype=torch.bfloat16),
            'b': torch.as_tensor(rng.randn(64), dtype=torch.float32)}


@pytest.mark.parametrize('int8', [False, True])
def test_add_stem_kernel_weights_keeps_jax_layout(int8):
    rng = np.random.RandomState(7)
    conv1 = _conv1(rng, int8)
    before = {k: v.clone() for k, v in conv1.items()}
    FO.add_stem_kernel_weights(conv1)
    assert set(conv1) == set(before) | {'wk', 'wk_siamese'}
    for k, v in before.items():
        assert torch.equal(conv1[k], v) and conv1[k].dtype == v.dtype
    assert torch.equal(conv1['wk'], SK.stem_kernel_weights(before['w']))
    wide = FO.siamese_conv1(conv1)
    plain_wide = FO.siamese_conv1(before)
    assert set(wide) == set(plain_wide) | {'wk'}
    for k, v in plain_wide.items():
        assert torch.equal(wide[k], v)
    assert torch.equal(wide['wk'], SK.stem_kernel_weights(plain_wide['w']))
    assert wide['wk'].shape[0 if int8 else 1] == 128


def test_int8c_add_kernel_weights_adds_the_stem_key():
    rng = np.random.RandomState(8)
    blk = {'conv1': {'w': torch.zeros((1, 1, 64, 64), dtype=torch.int8)},
           'conv2': {'w': torch.zeros((3, 3, 64, 64), dtype=torch.int8)},
           'conv3': {'w': torch.zeros((1, 1, 64, 256), dtype=torch.int8)}}
    q = {'conv1': _conv1(rng, True),
         **{f'layer{i}': [dict(blk)] for i in range(1, 5)}}
    w = q['conv1']['w'].clone()
    Q.add_kernel_weights(q)
    assert torch.equal(q['conv1']['w'], w)
    assert torch.equal(q['conv1']['wk'], SK.stem_kernel_weights(w))
    assert 'wk_siamese' in q['conv1'] and 'wk' in q['layer1'][0]


def test_cpu_builds_keep_only_the_jax_layout():
    """Models built on the CPU (the trees the tests compare with JAX) get
    no kernel weights; the CPU wrappers ignore wk."""
    from instaorder_tpu_torch import serving
    params, _ = serving.build_parity_model(0, device='cpu')
    assert set(params['conv1']) == {'w', 'b'}
    rng = np.random.RandomState(9)
    x = torch.as_tensor(rng.randn(1, 16, 16, 5), dtype=torch.bfloat16)
    c1 = params['conv1']
    b = c1['b'].float()
    assert torch.equal(SK.fused_stem(x, c1['w'], b),
                       SK.fused_stem(x, c1['w'], b,
                                     wk=SK.stem_kernel_weights(c1['w'])))


# ---- the f32 stem (csrc/stem.cu `stem_f32_kernel`, 3xTF32 on wgmma) -------

F32_SIZES = [(1, 64), (3, 128), (5, 64), (5, 128), (3, 64), (1, 128)]


def _f32_case(seed, c, cout, hw=30):
    rng = np.random.RandomState(seed)
    x = torch.as_tensor(rng.randn(2, hw, hw, c), dtype=torch.float32)
    w = torch.as_tensor(rng.randn(7, 7, c, cout) / np.sqrt(49 * c),
                        dtype=torch.float32)
    b = torch.as_tensor(rng.randn(cout) * 0.1, dtype=torch.float32)
    return x, w, b


@pytest.mark.parametrize('c', [1, 2, 3, 4, 5])
def test_f32_pack_is_the_s2d_input(c):
    """At f32 a 16-byte chunk holds 4 values: the pack holds
    s2d_stem_input's 4C channels as exactly C planes, no padding."""
    x = torch.as_tensor(np.random.RandomState(c).randn(2, 12, 10, c),
                        dtype=torch.float32)
    xs = SK.stem_pack_plain(x)
    assert SK.stem_chunks(torch.float32, c) == (c, 4)
    assert tuple(xs.shape) == (2, 9, c, 8, 4) and xs.dtype == torch.float32
    flat = xs.permute(0, 1, 3, 2, 4).reshape(2, 9, 8, 4 * c)
    assert torch.equal(flat, SK.s2d_stem_input(x))


@pytest.mark.parametrize('c', [1, 2, 3, 4, 5])
def test_f32_stem_steps_skip_only_zero_weights(c):
    """The k8 steps (du, dxp, j) the f32 kernel leaves out, du = 0 chunks
    j < C // 2, hold only the pad row's zero weights (sy = 0), so
    skipping them adds the same exact zeros; every one of the 49 C
    weights lies in one kept step. K = 8 (8C - 2 (C // 2)): 288 at C =
    5."""
    steps = SK.f32_stem_steps(c)
    assert len(steps) == 8 * c - 2 * (c // 2)
    assert steps == sorted(steps) and len(set(steps)) == len(steps)
    marks = torch.arange(1, 49 * c + 1, dtype=torch.float64).reshape(
        7, 7, c, 1)
    w2 = SK.s2d_conv1_w(marks).reshape(4, 2, 2, c, 4).permute(0, 1, 3, 2, 4)
    kept = torch.zeros(49 * c + 1, dtype=torch.int64)
    for du in range(4):
        for dxp in range(2):
            for j in range(c):
                vals = w2[du, dxp, j].flatten().long()
                if (du, dxp, j) in steps:
                    kept += torch.bincount(vals, minlength=49 * c + 1)
                else:
                    assert du == 0 and j < c // 2 and not vals.any()
    assert (kept[1:] == 1).all()
    if c == 5:
        assert 8 * len(steps) == 288


def _tf32_np(a):
    """numpy model of cvt.rna.tf32.f32 (10 mantissa bits, ties away from
    zero), independent of gemm_layout.tf32."""
    a = np.asarray(a, np.float32)
    m, e = np.frexp(a.astype(np.float64))
    r = np.sign(m) * np.floor(np.abs(m) * 2.0 ** 11 + 0.5) / 2.0 ** 11
    return np.ldexp(r, e).astype(np.float32)


@pytest.mark.parametrize('c,cout', [(1, 64), (3, 128), (5, 128)])
def test_f32_stem_split_kmajor_weights(c, cout):
    """stem_kernel_weights at f32: one contiguous (2, Cout, K) tensor
    [hi, lo], K-major in the kernel's order (each step's 8 rows (e, i):
    tap column 2 dxp + e, channel 4 j + i of the s2d weights), hi =
    tf32(w), lo = tf32(w - hi), both TF32, hi + lo within 2^-22 |w|."""
    _, w, _ = _f32_case(c, c, cout)
    wk = SK.stem_kernel_weights(w)
    steps = SK.f32_stem_steps(c)
    assert tuple(wk.shape) == (2, cout, 8 * len(steps))
    assert wk.is_contiguous() and wk.dtype == torch.float32
    assert int((wk.view(torch.int32) & 0x1fff).count_nonzero()) == 0
    w2 = SK.s2d_conv1_w(w).numpy()                  # (du, dxu, ch, co)
    want = np.stack([w2[du, 2 * dxp + e, 4 * j + i]
                     for du, dxp, j in steps for e in range(2)
                     for i in range(4)], axis=1)    # (co, K)
    hi, lo = wk[0].numpy(), wk[1].numpy()
    np.testing.assert_array_equal(hi, _tf32_np(want))
    np.testing.assert_array_equal(lo, _tf32_np(want - hi))
    err = np.abs(hi.astype(np.float64) + lo - want)
    assert (err <= 2.0 ** -22 * np.abs(want)).all()


def _kernel_groups(c):
    """The f32 kernel's K steps in order (StemF: each (du, dxp) holds the
    chunks jlo .. C - 1, jlo = C // 2 at du = 0; three or more are split
    in two, the first half larger), as lists of k8 indices."""
    steps = SK.f32_stem_steps(c)
    groups = []
    for du in range(4):
        for dxp in range(2):
            ks = [k for k, s in enumerate(steps) if s[:2] == (du, dxp)]
            if len(ks) >= 3:
                h = (len(ks) + 1) // 2
                groups += [ks[:h], ks[h:]]
            else:
                groups.append(ks)
    assert max(len(g) for g in groups) <= 3
    return groups


def _rz(x):
    """f64 values rounded toward zero to f32 (the tensor cores' sums)."""
    r = x.float()
    over = r.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(r, torch.zeros_like(r)),
                       r).double()


def _kernel_sums(xs, wk, c):
    """A model of the f32 kernel's sums: the packed input xs (N, Hs, C,
    Ws, 4) times wk (2, Cout, K), each k8 step's A the 8 values (e, i) of
    chunk j at s2d pixels v + 2 dxp + e of row r + du; A's hi = trunc(a)
    (a with its low 13 mantissa bits cleared: what tf32 wgmma reads of
    the raw f32 in shared memory) and lo = tf32(a - hi), which each thread
    forms in registers. Each K step sums, into a fresh accumulator, its
    small products
    (lo_a . hi_b, hi_a . lo_b of each k8) and then its hi_a . hi_b, every
    add rounded toward zero to f32; the step's sum is added into the f32
    total rounded to nearest."""
    n, hs, _, ws, _ = xs.shape
    hc, wc = hs - 3, ws - 3
    steps = SK.f32_stem_steps(c)
    ah = (xs.contiguous().view(torch.int32) & -0x2000).view(torch.float32)
    al = gemm_layout.tf32(xs - ah)
    bh, bl = wk[0].double(), wk[1].double()

    def a_of(t, k):
        du, dxp, j = steps[k]
        return torch.cat([t[:, du:du + hc, j, 2 * dxp + e:2 * dxp + e + wc]
                          for e in (0, 1)], dim=-1).double()

    tot = torch.zeros((n, hc, wc, wk.shape[1]), dtype=torch.float32)
    for ks in _kernel_groups(c):
        seq = ([p for k in ks for p in ((al, bh, k), (ah, bl, k))]
               + [(ah, bh, k) for k in ks])
        acc = torch.zeros(tot.shape, dtype=torch.float64)
        for t, wt, k in seq:
            acc = _rz(acc + a_of(t, k) @ wt[:, 8 * k:8 * k + 8].t())
        tot = tot + acc.float()
    return tot


@pytest.mark.parametrize('c,cout', F32_SIZES)
def test_f32_kernel_sums_equal_plain_stem(c, cout):
    """The f32 kernel's arithmetic on the CPU (_kernel_sums over the pack
    and the split weights, the zero k8 steps skipped), + bias, relu,
    pool, equals fused_stem_plain within 1e-5 of max |plain| (the stem's
    f32 bar; the model sits near 5e-7, the card at 2.2e-7 of an f64
    reference, `sweep_f32.py --stem`). A's split is exact: hi + lo is
    within 2^-22 |a| of a."""
    x, w, b = _f32_case(10 * c + cout, c, cout)
    xs = SK.stem_pack_plain(x)
    hi = (xs.view(torch.int32) & -0x2000).view(torch.float32)
    lo = gemm_layout.tf32(xs - hi)
    assert torch.equal(hi + (xs - hi), xs)
    err = (hi.double() + lo.double() - xs.double()).abs()
    assert bool((err <= 2.0 ** -22 * xs.double().abs()).all())
    got = _pool(torch.relu(_kernel_sums(xs, SK.stem_kernel_weights(w), c)
                           + b))
    want = SK.fused_stem_plain(x, w, b)
    assert got.shape == want.shape
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * scale
    assert float((want != 0).float().mean()) > 0.05


def test_f32_stem_fragments_cover_the_conv_row():
    """csrc/stem.cu `stem_f32_kernel`'s ownership at one k8 step: the lo
    fragments (tf32 wgmma from registers: a[i] of a lane holds row 16
    warp + lane / 4 + 8 (i % 2), column lane % 4 + 4 (i / 2) of its
    warpgroup's 64) cover each warpgroup's 64 x 8 tile once, at the ring
    offsets the kernel loads (pixel m (+8) for e = 0, m + 1 (+9) for e =
    1, element lane % 4: byte offsets 0, 128, 16, 144 from its origin),
    the same elements the in-place hi operand's descriptor addresses,
    and each warp's load of one register reads 32 distinct banks; the
    accumulators cover the 128 x 64 conv tile once, and the epilogue's
    8-byte stores into the conv buffer (rows of kLdcF = 72 f32) fall in
    distinct banks per half-warp."""
    ldc = 72
    seen = np.zeros((2, 64, 8), np.int32)
    for tid in range(256):
        wg, warp, lane = tid // 128, (tid // 32) % 4, tid % 32
        m = 16 * warp + lane // 4
        origin = (64 * wg + m) * 16 + (lane % 4) * 4
        for i, off in enumerate((0, 128, 16, 144)):
            row, col = m + 8 * (i % 2), lane % 4 + 4 * (i // 2)
            seen[wg, row, col] += 1
            e, elem = col // 4, col % 4
            assert origin + off == (64 * wg + row + e) * 16 + elem * 4
    assert (seen == 1).all()
    # A's hi, read in place (SS): a K-major operand without swizzle, 8 x
    # 16-byte core matrices, LBO 16 (the two along K), SBO 128 (8-row
    # groups); element (m, k) lands on pixel m + k // 4 (tap e), element
    # k % 4 of the chunk: where the lo fragments are read
    for m in range(64):
        for k in range(8):
            ss = (m // 8) * 128 + (k // 4) * 16 + (m % 8) * 16 + (k % 4) * 4
            assert ss == (m + k // 4) * 16 + (k % 4) * 4
    for warp in range(8):
        for off in (0, 128, 16, 144):
            words = {((64 * (warp // 4) + 16 * (warp % 4) + lane // 4) * 16
                      + (lane % 4) * 4 + off) // 4 for lane in range(32)}
            assert len({wd % 32 for wd in words}) == 32
    owned = np.zeros((128, 64), np.int32)
    for tid in range(256):
        lane, warp = tid % 32, tid // 32
        for j in range(8):
            for h in range(2):
                row = 64 * (tid // 128) + 16 * (warp % 4) + lane // 4 + 8 * h
                col = 8 * j + 2 * (lane % 4)
                owned[row, col:col + 2] += 1
    assert (owned == 1).all()
    for warp in range(8):
        for half in (range(16), range(16, 32)):
            for j in range(8):
                banks = set()
                for lane in half:
                    row = 16 * (warp % 4) + lane // 4
                    w0 = row * ldc + 8 * j + 2 * (lane % 4)
                    banks |= {w0 % 32, (w0 + 1) % 32}
                assert len(banks) == 32


def test_f32_stem_shared_memory():
    """The f32 kernel's shared memory (StemF): a 64-channel half's hi and
    lo weights in 128-byte K blocks, four raw s2d rows of a 131-pixel
    tile row, the conv buffer, the bias and the alignment slack fit the
    232,448 bytes a block may use for every C (227,520 at C = 5); the
    design's alternatives do not: at K = 320 (no zero steps skipped), or
    with a fifth ring slot, or with A split into hi and lo planes."""
    def smem(c, k8=None, slots=4, planes=1):
        k8 = 8 * c - 2 * (c // 2) if k8 is None else k8
        weights = 2 * -(-k8 // 4) * 64 * 128
        return weights + slots * planes * c * 131 * 16 + 128 * 72 * 4 \
            + 64 * 4 + 1024
    limit = 232448
    for c in range(1, 6):
        assert smem(c) <= limit
    assert smem(5) == 227520
    assert 2 * 9 * 64 * 128 == 147456 and 5 * 131 * 16 == 10480
    assert smem(5, k8=40) > limit
    assert smem(5, slots=5) > limit
    assert smem(5, planes=2) > limit


def test_add_stem_kernel_weights_f32_keeps_jax_layout():
    """An f32 model built on the card gets the split s2d weights for both
    stems (`wk`, and `wk_siamese`, which siamese_conv1 hands on as the
    double-width stem's `wk`); the JAX-layout w stays as it was."""
    rng = np.random.RandomState(31)
    conv1 = {'w': torch.as_tensor(rng.randn(7, 7, 5, 64),
                                  dtype=torch.float32),
             'b': torch.as_tensor(rng.randn(64), dtype=torch.float32)}
    before = {k: v.clone() for k, v in conv1.items()}
    assert FO.add_stem_kernel_weights(conv1) is conv1
    assert set(conv1) == {'w', 'b', 'wk', 'wk_siamese'}
    for k, v in before.items():
        assert torch.equal(conv1[k], v) and conv1[k].dtype == v.dtype
    assert tuple(conv1['wk'].shape) == (2, 64, 288)
    assert torch.equal(conv1['wk'], SK.stem_kernel_weights(before['w']))
    wide = FO.siamese_conv1(conv1)
    assert tuple(wide['wk'].shape) == (2, 128, 288)
    assert torch.equal(wide['wk'],
                       SK.stem_kernel_weights(FO.siamese_conv1(before)['w']))
