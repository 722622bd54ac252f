"""The host-side layout decisions of the implicit-GEMM block kernels
(instaorder_tpu_torch/ops/gemm_layout.py) on the CPU: the CTA's output
width by Cout (and by K for the f32 kernel), the K-step rule of the
K-packed projection, and the int8 weights' K-major (Cout, K) layout,
held against a plain x @ w and the exact int8 convolution. The kernels themselves run only on the card
(tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from instaorder_tpu_torch import serving
from instaorder_tpu_torch.models import quantize as TQ
from instaorder_tpu_torch.ops import gemm_layout as GL
from instaorder_tpu_torch.ops import int8_kernels as IK
import torch_threads  # noqa: F401 (the suite's torch thread cap)


@pytest.mark.parametrize('cout,bn', [(64, 64), (128, 128), (192, 64),
                                     (256, 128), (512, 128), (2048, 128)])
def test_tile_n(cout, bn):
    assert GL.tile_n(cout) == bn
    assert cout % GL.tile_n(cout) == 0


@pytest.mark.parametrize('cout', [64, 128, 256, 2048])
def test_tile_n_two_sums(cout):
    """The int8 projection's tile: 64 columns at every width."""
    assert GL.tile_n(cout, two_sums=True) == 64


@pytest.mark.parametrize('cout,k,bn', [
    (64, 576, 64), (256, 64, 64), (256, 128, 64), (512, 128, 64),
    (128, 512, 128), (512, 384, 128), (1024, 768, 128), (512, 4608, 128)])
def test_tile_n_f32(cout, k, bn):
    """The f32 kernel's tile: 64 columns where Cout needs them or the K
    axis is at most F32_SHORT_K (two 64-wide CTAs an SM), else 128."""
    assert GL.tile_n_f32(cout, k) == bn
    with pytest.raises(ValueError, match='multiple of 64'):
        GL.tile_n_f32(cout + 32, k)


@pytest.mark.parametrize('cout', [0, 32, 100, 200])
def test_tile_n_refuses(cout):
    with pytest.raises(ValueError, match='multiple of 64'):
        GL.tile_n(cout)


@pytest.mark.parametrize('ks,step,steps', [
    ([64], 64, [1]), ([96], 64, [2]), ([32], 64, [1]),
    ([64, 64], 64, [1, 1]), ([512, 1024], 64, [8, 16]),
    ([128, 96], 64, [2, 2]), ([64], 128, [1]), ([4608], 128, [36])])
def test_check_k_steps(ks, step, steps):
    assert GL.check_k_steps(ks, step) == steps


@pytest.mark.parametrize('ks', [[96, 64], [32, 64], [100, 100]])
def test_check_k_steps_refuses_straddle(ks):
    with pytest.raises(ValueError, match='straddle'):
        GL.check_k_steps(ks)


def _i8(rng, *shape):
    return torch.as_tensor(rng.randint(-127, 128, shape), dtype=torch.int8)


@pytest.mark.parametrize('m,cin,cout', [(5, 64, 64), (7, 256, 64),
                                        (3, 512, 2048)])
def test_kmajor_1x1_matches_matmul(m, cin, cout):
    """x @ w == x @ kmajor(w).T, exactly (int64 sums)."""
    rng = np.random.RandomState(cin + cout)
    x, w = _i8(rng, m, cin), _i8(rng, cin, cout)
    wk = GL.kmajor(w)
    assert tuple(wk.shape) == (cout, cin) and wk.is_contiguous()
    assert wk.dtype == torch.int8
    assert torch.equal(x.long() @ w.long(), x.long() @ wk.long().t())
    assert torch.equal(GL.kmajor(w[None, None]), wk)


@pytest.mark.parametrize('c,cout,stride', [(16, 64, 1), (64, 128, 2)])
def test_kmajor_3x3_matches_conv(c, cout, stride):
    """The im2col rows in the kernel's K order (tap-major: dy, dx, then
    channel) times kmajor(w).T equal the exact int8 convolution."""
    rng = np.random.RandomState(c + stride)
    x, w = _i8(rng, 2, 7, 7, c), _i8(rng, 3, 3, c, cout)
    want = IK.conv_int8(x, w, stride, 1)
    xp = torch.nn.functional.pad(x.long(), (0, 0, 1, 1, 1, 1))
    ho = want.shape[1]
    taps = [xp[:, dy:dy + stride * (ho - 1) + 1:stride,
               dx:dx + stride * (ho - 1) + 1:stride]
            for dy in range(3) for dx in range(3)]
    cols = torch.cat(taps, dim=-1)                 # (N, Ho, Wo, 9 C)
    got = cols @ GL.kmajor(w).long().t()
    assert torch.equal(got, want.long())


def test_kmajor_refuses_other_ranks():
    with pytest.raises(ValueError):
        GL.kmajor(torch.zeros((3, 64, 64), dtype=torch.int8))


@pytest.fixture(scope='module')
def int8c_model():
    rng = np.random.RandomState(0)
    x = torch.as_tensor(rng.randn(2, 32, 32, 5), dtype=torch.float32)
    q, cfg = serving.build_int8c_model(0, x, device='cpu',
                                       weight_init='kaiming_out')
    return q, cfg, x


def test_int8c_model_on_the_cpu_keeps_the_jax_layout(int8c_model):
    """Only a model built on the card carries kernel weights: the tree the
    CPU tests compare with JAX has exactly JAX's keys."""
    q, _, _ = int8c_model
    for li in range(4):
        for qb in q[f'layer{li + 1}']:
            assert 'wk' not in qb


def test_add_kernel_weights(int8c_model):
    """Every block gets (Cout, K) copies of w1, w2, w3 (and wd), equal to
    kmajor of its JAX-layout weights; the trunk's output does not move
    (the plain versions read the JAX layout)."""
    q, cfg, x = int8c_model
    x8 = TQ.quantize_input(x, q['cfg_scales']['in'])
    h = TQ._stem_int8(q, x8)
    want = TQ._trunk_int8(q, cfg, h, use_pallas=('identity', 'down'))
    qk = TQ.add_kernel_weights({k: ([dict(b) for b in v]
                                    if k.startswith('layer') else v)
                                for k, v in q.items()})
    for li in range(4):
        for qb in qk[f'layer{li + 1}']:
            convs = [c for c in ('conv1', 'conv2', 'conv3', 'down')
                     if c in qb]
            assert len(qb['wk']) == len(convs)
            for c, wk in zip(convs, qb['wk']):
                w = qb[c]['w']
                assert tuple(wk.shape) == (w.shape[-1], w[..., 0].numel())
                assert torch.equal(wk, GL.kmajor(w))
    for feats in (('identity', 'down'), ('hwnc', 'down')):
        assert torch.equal(TQ._trunk_int8(qk, cfg, h, use_pallas=feats),
                           want)
