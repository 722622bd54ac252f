"""Plain versions of the port's bottleneck kernels (kernels 2-4) against
the three Pallas kernels they replace, run in interpret mode on the CPU.

The JAX kernels take the (H, W, N, C) view; the port takes NHWC, so
inputs and outputs are transposed to compare. Bar: outputs (integers
0..127) differ by at most 1 (one int8 LSB) on under 1% of elements —
the f32 sums run in another order, which can move an exact round() tie.
Both the f32 compute dtype (tests) and bf16 (serving) are checked, with
int8 and compute-dtype outputs."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from instaorder_tpu.ops import pallas_blocks as PB

from instaorder_tpu_torch.ops import bottleneck_kernels as BK
import torch_threads  # noqa: F401 (the suite's torch thread cap)

H = W = 16
N = 2


def _w(rng, shape, scale):
    return rng.randn(*shape).astype(np.float32) * scale


def _params(rng, cin, cm, cout, down):
    p = [_w(rng, (cin, cm), 0.6 / np.sqrt(cin) / 40),
         rng.randn(cm).astype(np.float32) * 0.2,
         _w(rng, (3, 3, cm, cm), 1.2 / np.sqrt(9 * cm)),
         rng.randn(cm).astype(np.float32) * 0.2,
         _w(rng, (cm, cout), 40.0 / np.sqrt(cm)),
         rng.randn(cout).astype(np.float32) * 5.0]
    if down:
        p += [_w(rng, (cin, cout), 1.0 / np.sqrt(cin)),
              rng.randn(cout).astype(np.float32) * 5.0]
    return p


def _cast(p, dt):
    """Weights (even positions) to the compute dtype, biases f32."""
    jdt = jnp.bfloat16 if dt == 'bf16' else jnp.float32
    tdt = torch.bfloat16 if dt == 'bf16' else torch.float32
    jp = [jnp.asarray(a, jdt if i % 2 == 0 else jnp.float32)
          for i, a in enumerate(p)]
    tp = [torch.from_numpy(a).to(tdt if i % 2 == 0 else torch.float32)
          for i, a in enumerate(p)]
    return jp, tp


def _to_hwnc(x):
    return jnp.asarray(np.transpose(x, (1, 2, 0, 3)))


def _from_hwnc(y):
    return np.transpose(np.asarray(y, np.float32), (2, 0, 1, 3))


def _compare(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    d = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert d.max() <= 1, d.max()
    assert (d > 0).mean() < 0.01, (d > 0).mean()
    inner = ((want > 0) & (want < 127)).mean()
    assert inner > 0.2, f'degenerate test data: {inner:.2f} unclipped'


def _x(rng, c):
    return rng.randint(0, 128, (N, H, W, c)).astype(np.int8)


@pytest.mark.parametrize('dt', ['f32', 'bf16'])
@pytest.mark.parametrize('out_int8', [True, False])
def test_identity_plain_matches_pallas(dt, out_int8):
    rng = np.random.RandomState(0)
    x = _x(rng, 64)
    jp, tp = _cast(_params(rng, 64, 16, 64, False), dt)
    r = 0.37
    want = _from_hwnc(PB.fused_bottleneck_i8v2_hwnc(
        _to_hwnc(x), *jp, r, interpret=True, out_int8=out_int8))
    got = BK.fused_bottleneck_i8v2_identity(torch.from_numpy(x), *tp, r,
                                            out_int8=out_int8)
    assert got.dtype == (torch.int8 if out_int8 else tp[0].dtype)
    _compare(got, want)


@pytest.mark.parametrize('dt', ['f32', 'bf16'])
@pytest.mark.parametrize('out_int8', [True, False])
def test_down_s2_plain_matches_pallas(dt, out_int8):
    rng = np.random.RandomState(1)
    x = _x(rng, 64)
    jp, tp = _cast(_params(rng, 64, 16, 128, True), dt)
    want = _from_hwnc(PB.fused_bottleneck_down_s2_i8v2_hwnc(
        _to_hwnc(x), *jp, interpret=True, out_int8=out_int8))
    got = BK.fused_bottleneck_i8v2_down_s2(torch.from_numpy(x), *tp,
                                           out_int8=out_int8)
    assert tuple(got.shape) == (N, H // 2, W // 2, 128)
    _compare(got, want)


@pytest.mark.parametrize('dt', ['f32', 'bf16'])
def test_stage_plain_matches_pallas(dt):
    """layer1: the stride-1 projection block then two identity blocks."""
    rng = np.random.RandomState(2)
    x = _x(rng, 32)
    down = _params(rng, 32, 16, 64, True)
    blocks = [_params(rng, 64, 16, 64, False) for _ in range(2)]
    rs = [0.4, 0.6]
    jd, td = _cast(down, dt)
    jb, tb = zip(*[_cast(b, dt) for b in blocks])
    flat = list(jd) + [a for b in jb for a in b]
    want = _from_hwnc(PB.fused_bottleneck_i8v2_hwnc_stage(
        _to_hwnc(x), *flat, jnp.asarray(rs, jnp.float32), nblocks=2,
        down=True, staging='act', out_int8=True, interpret=True))
    got = BK.fused_bottleneck_i8v2_stage(torch.from_numpy(x), td,
                                         list(tb), rs)
    assert got.dtype == torch.int8
    _compare(got, want)
