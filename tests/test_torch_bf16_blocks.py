"""Plain versions of the port's kernels 5, 10, 13 and 15 against the
Pallas kernels they replace, run in interpret mode on the CPU, at the
small shapes of tests/test_pallas_blocks.py and tests/test_prep_pallas.py.

Bars: f32 atol 2e-5 (1e-5 for the stem), as the JAX package's own
kernel tests; bf16 within 1e-2 of the output scale (f32 sums in another
order can move a bf16 rounding by one ulp, and a moved h1/h2 value moves
the next stage); q8 stem within one int8 LSB on under 1% of values; the
RGB prep within one uint8 LSB on under 1% of pixels, masks exact."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from instaorder_tpu.ops import pairs as JP
from instaorder_tpu.ops import pallas_blocks as PB
from instaorder_tpu.ops.prep_pallas import fused_prep_rgb as j_prep_rgb

from instaorder_tpu_torch.ops import bottleneck_bf16_kernels as BK16
from instaorder_tpu_torch.ops import pairs as TP
from instaorder_tpu_torch.ops import prep_kernels as PK
from instaorder_tpu_torch.ops import stem_kernels as SK
import torch_threads  # noqa: F401 (the suite's torch thread cap)

DT = {'f32': (jnp.float32, torch.float32),
      'bf16': (jnp.bfloat16, torch.bfloat16)}


def _both(arrs, dt):
    jdt, tdt = DT[dt]
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.from_numpy(np.asarray(a, np.float32)).to(tdt)
             for a in arrs])


def _close(got, want, dt, atol):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dt == 'f32':
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    else:
        scale = float(np.abs(want).max())
        assert np.abs(got - want).max() <= 1e-2 * scale, \
            (np.abs(got - want).max(), scale)
    assert np.count_nonzero(want) > 0.05 * want.size, 'degenerate data'


def _identity_block(seed, N=2, H=16, W=16, cin=256, cm=64):
    """tests/test_pallas_blocks.py make_block."""
    rng = np.random.RandomState(seed)
    x = rng.randn(N, H, W, cin).astype(np.float32)
    args = (rng.randn(cin, cm).astype(np.float32) * 0.05,
            rng.randn(cm).astype(np.float32) * 0.1,
            rng.randn(3, 3, cm, cm).astype(np.float32) * 0.05,
            rng.randn(cm).astype(np.float32) * 0.1,
            rng.randn(cm, cin).astype(np.float32) * 0.05,
            rng.randn(cin).astype(np.float32) * 0.1)
    return x, args


@pytest.mark.parametrize('dt', ['f32', 'bf16'])
@pytest.mark.parametrize('geom', [(0, 2, 16, 256, 64), (1, 2, 8, 128, 32)])
def test_fused_bottleneck_plain_matches_pallas(dt, geom):
    seed, n, hw, cin, cm = geom
    x, args = _identity_block(seed, N=n, H=hw, W=hw, cin=cin, cm=cm)
    (jx, *jw), (tx, *tw) = _both((x,) + args, dt)
    # the kernels take f32 biases (the TPU kernel casts them)
    tw[1::2] = [b.float() for b in tw[1::2]]
    want = PB.fused_bottleneck(jx, *jw, interpret=True)
    got = BK16.fused_bottleneck(tx, *tw)
    assert got.dtype == DT[dt][1]
    _close(got, want, dt, 2e-5)


@pytest.mark.parametrize('dt', ['f32', 'bf16'])
@pytest.mark.parametrize('stride,cin,cm,cout', [
    (1, 64, 64, 256),    # layer1[0]: channel projection, no spatial down
    (2, 256, 128, 512),  # layer2[0]
])
def test_fused_bottleneck_down_plain_matches_pallas(dt, stride, cin, cm,
                                                    cout):
    rng = np.random.RandomState(0)
    H = 16
    x = rng.randn(4, H, H, cin).astype(np.float32)
    w = [rng.randn(cin, cm) * 0.1, rng.randn(cm),
         rng.randn(3, 3, cm, cm) * 0.1, rng.randn(cm),
         rng.randn(cm, cout) * 0.1, rng.randn(cout),
         rng.randn(cin, cout) * 0.1, rng.randn(cout)]
    (jx, *jw), (tx, *tw) = _both([x] + w, dt)
    tw[1::2] = [b.float() for b in tw[1::2]]
    want = PB.fused_bottleneck_down(jx, *jw, stride=stride, interpret=True,
                                    batch_tile=2)
    got = BK16.fused_bottleneck_down(tx, *tw, stride=stride)
    assert tuple(got.shape) == (4, H // stride, H // stride, cout)
    _close(got, want, dt, 2e-5)


def test_fused_bottleneck_plain_matches_xla_reference():
    """The plain version against the XLA oracle the JAX tests use, at
    the border-behaviour geometry (per-image zero padding)."""
    x, args = _identity_block(1, N=2, H=8, W=8, cin=128, cm=32)
    x[0], x[1] = 1.0, -1.0
    want = PB.bottleneck_reference(jnp.asarray(x), *map(jnp.asarray, args))
    got = BK16.fused_bottleneck_plain(torch.from_numpy(x),
                                      *map(torch.from_numpy, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    w = [np.asarray(a) for a in args]
    wd = np.random.RandomState(2).randn(128, 128).astype(np.float32) * 0.05
    bd = np.random.RandomState(3).randn(128).astype(np.float32) * 0.1
    want = PB.bottleneck_down_reference(
        jnp.asarray(x), *map(jnp.asarray, w), jnp.asarray(wd),
        jnp.asarray(bd), stride=2)
    got = BK16.fused_bottleneck_down_plain(
        torch.from_numpy(x), *map(torch.from_numpy, w + [wd, bd]), stride=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def _stem_inputs(seed=4, n=2, hw=32, cout=64):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, hw, hw, 5).astype(np.float32)
    w = rng.randn(7, 7, 5, cout).astype(np.float32) * 0.05
    b = rng.randn(cout).astype(np.float32) * 0.1
    return x, w, b


@pytest.mark.parametrize('dt', ['f32', 'bf16'])
@pytest.mark.parametrize('cout', [64, 128])
def test_fused_stem_plain_matches_pallas(dt, cout):
    x, w, b = _stem_inputs(cout=cout)
    (jx, jw, _), (tx, tw, _) = _both((x, w, b), dt)
    want = PB.fused_stem(jx, jw, jnp.asarray(b), interpret=True,
                         batch_tile=2)
    got = SK.fused_stem(tx, tw, torch.from_numpy(b))
    assert got.dtype == DT[dt][1] and tuple(got.shape) == (2, 8, 8, cout)
    _close(got, want, dt, 1e-5)
    if dt == 'f32':
        ref = PB.stem_reference(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(b))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize('dt', ['f32', 'bf16'])
def test_fused_stem_q8_plain_matches_pallas(dt):
    """q8: the pooled values scaled into the int8 range, as the v2 stem
    (1/s_stem folded into w and b)."""
    x, w, b = _stem_inputs(seed=6, cout=128)
    w, b = w * 40.0, b * 40.0
    (jx, jw, _), (tx, tw, _) = _both((x, w, b), dt)
    want = np.asarray(PB.fused_stem(jx, jw, jnp.asarray(b), interpret=True,
                                    batch_tile=2, q8=True), np.int32)
    got = SK.fused_stem(tx, tw, torch.from_numpy(b), q8=True)
    assert got.dtype == torch.int8
    d = np.abs(got.numpy().astype(np.int32) - want)
    assert d.max() <= 1 and (d > 0).mean() < 0.01, (d.max(), (d > 0).mean())
    live = ((want > 0) & (want < 127)).mean()
    assert live > 0.2, f'degenerate test data: {live:.2f} unclipped'


def _prep_scenes(seed, S=2, H=96, W=128, N=4):
    """tests/test_prep_pallas.py geometry: random in-image bboxes."""
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 255, (S, H, W, 3)).astype(np.float32)
    masks = np.zeros((S, N, H, W), np.float32)
    bboxes = np.zeros((S, N, 4), np.float32)
    for s in range(S):
        for k in range(N):
            y0, x0 = rng.randint(0, H - 20), rng.randint(0, W - 20)
            hh, ww = rng.randint(5, 60, 2)
            masks[s, k, y0:y0 + hh, x0:x0 + ww] = 1
            bboxes[s, k] = [x0, y0, ww, hh]
    pidx, _ = JP.all_pair_indices(N)
    rois = np.array(jax.vmap(lambda b: JP.pair_rois(b, jnp.asarray(pidx)))(
        jnp.asarray(bboxes)))
    return images, masks, pidx, rois


def _rgb_close(got, want, lsb):
    d = np.abs(got - want)
    assert d.max() <= lsb + 1e-6, d.max()
    assert (d > 0).mean() < 0.01, (d > 0).mean()


@pytest.mark.parametrize('passes', [3, 1])
@pytest.mark.parametrize('normalize', [True, False])
def test_prep_rgb_plain_matches_pallas(passes, normalize):
    images, _, _, rois = _prep_scenes(4)
    want = np.transpose(np.asarray(j_prep_rgb(
        jnp.asarray(images), jnp.asarray(rois), out_size=64,
        normalize=normalize, passes=passes, interpret=True), np.float32),
        (0, 2, 3, 1))
    got = PK.fused_prep_rgb(torch.from_numpy(images), torch.from_numpy(rois),
                            out_size=64, normalize=normalize, passes=passes)
    assert got.dtype == torch.bfloat16 and got.shape == (12, 64, 64, 3)
    # one uint8 LSB: one bf16 step after normalisation, 1 (or the bf16
    # step at 128..255, 1 too) on the raw integers
    _rgb_close(got.float().numpy(), want, 0.03125 if normalize else 1.0)


@pytest.mark.parametrize('passes', [3, 1])
def test_pair_batches_rgb_route_matches_jax(passes):
    """build_pair_batches_fused's RGB-kernel route (fuse_masks=False)
    against the JAX one: masks exact, RGB within one LSB."""
    images, masks, pidx, rois = _prep_scenes(5)
    want = np.asarray(JP.build_pair_batches_fused(
        jnp.asarray(images), jnp.asarray(masks), jnp.asarray(pidx),
        jnp.asarray(rois), out_size=64, passes=passes, interpret=True),
        np.float32)
    got = TP.build_pair_batches_fused(
        torch.from_numpy(images), torch.from_numpy(masks), pidx,
        torch.from_numpy(rois), out_size=64, passes=passes).float().numpy()
    assert got.shape == want.shape == (12, 64, 64, 5)
    np.testing.assert_array_equal(got[..., :2], want[..., :2])
    _rgb_close(got[..., 2:], want[..., 2:], 0.03125)


def test_pair_batches_matmul_matches_jax():
    """The multi-scene einsum prep (the parity profile's) against the
    JAX one vmapped over scenes, in bf16 as the parity bench asks."""
    images, masks, pidx, rois = _prep_scenes(6)
    pj = jnp.asarray(pidx)
    want = np.asarray(jax.vmap(lambda im, m, r: JP.build_pair_batch_matmul(
        im, m, pj, r, out_size=64, dtype=jnp.bfloat16))(
        jnp.asarray(images), jnp.asarray(masks), jnp.asarray(rois)),
        np.float32).reshape(-1, 64, 64, 5)
    got = TP.build_pair_batches_matmul(
        torch.from_numpy(images), torch.from_numpy(masks), pidx,
        torch.from_numpy(rois), out_size=64, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    np.testing.assert_array_equal(got[..., :2], want[..., :2])
    _rgb_close(got[..., 2:], want[..., 2:], 0.03125)
    m = TP._mask_pair_batch(torch.from_numpy(masks[0]), pidx,
                            torch.from_numpy(rois[0]), 64)
    np.testing.assert_array_equal(
        m.numpy(), np.asarray(JP._mask_pair_batch(
            jnp.asarray(masks[0]), pj, jnp.asarray(rois[0]), 64), np.float32))
