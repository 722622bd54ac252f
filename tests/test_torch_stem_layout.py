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
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from instaorder_tpu_torch.models import folding as FO
from instaorder_tpu_torch.models import quantize as Q
from instaorder_tpu_torch.ops import stem_kernels as SK
from instaorder_tpu_torch.ops.int8_kernels import requant

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
    xs = SK.stem_pack_plain(x)
    # the bf16 layout of the bf16 weights (an f32 w has the f32 stem's
    # own layout), widened back to f32 for the product
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
    """The planar pack holds s2d_stem_input's channels in order, then
    zeros; the relaid weights hold s2d_conv1_w's taps, then zeros."""
    rng = np.random.RandomState(3)
    x = torch.as_tensor(rng.randn(1, 12, 10, 5), dtype=torch.float32)
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
