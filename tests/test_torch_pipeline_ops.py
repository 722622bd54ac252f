"""The host and device ops under the port's OrderPredictor against the
JAX package on the CPU: resize, geometry, morphology, the per-roi
pair-batch functions, decode, the pair / hw buckets, and the f32-output
mode of the 5-channel prep kernel's plain version (row 1'').

Bars: indices, weights, masks, bordering and decode results equal; the
resizes within 1e-5 (f32 sums in another order); prep RGB within one
uint8 LSB on under 1% of pixels, masks exact (the tools/prep_gate.py
bar). The LSB is 2^-5 after normalisation in bf16 (one bf16 grid step)
and 1 / (255 * 0.224) in f32 (one uint8 step over the smallest std)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from instaorder_tpu.eval import decode as JD
from instaorder_tpu.eval import pipeline as JPL
from instaorder_tpu.ops import morphology as JM
from instaorder_tpu.ops import pairs as JP
from instaorder_tpu.ops import resize as JR
from instaorder_tpu.ops.prep_pallas import fused_prep_pairs as j_fused
from instaorder_tpu.utils.geometry import (
    get_closest_int_multiple_of as j_closest)

from instaorder_tpu_torch.eval import decode as TD
from instaorder_tpu_torch.eval import pipeline as TPL
from instaorder_tpu_torch.ops import morphology as TM
from instaorder_tpu_torch.ops import pairs as TP
from instaorder_tpu_torch.ops import prep_kernels as PK
from instaorder_tpu_torch.ops import resize as TR
from instaorder_tpu_torch.utils.geometry import get_closest_int_multiple_of
import torch_threads  # noqa: F401 (the suite's torch thread cap)

OUT = 64
LSB_F32 = 1.0 / (255.0 * 0.224) + 1e-6


def scene(seed, n=5, h=96, w=128):
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


def assert_prep_close(got, want, lsb, max_frac=0.01):
    np.testing.assert_array_equal(got[..., :2], want[..., :2])
    d = np.abs(got[..., 2:] - want[..., 2:])
    assert d.max() <= lsb, d.max()
    assert (d > 1e-5).mean() < max_frac, (d > 1e-5).mean()


# ---- resize and geometry --------------------------------------------------


@pytest.mark.parametrize('src,dst', [(480, 256), (123, 256), (96, 64),
                                     (37, 100)])
def test_resize_weights_and_indices_equal(src, dst):
    np.testing.assert_array_equal(TR.nearest_indices(src, dst),
                                  JR.nearest_indices(src, dst))
    np.testing.assert_array_equal(TR.resize_weights_linear(src, dst),
                                  JR.resize_weights_linear(src, dst))
    np.testing.assert_array_equal(TR.resize_weights_cubic(src, dst),
                                  JR.resize_weights_cubic(src, dst))


@pytest.mark.parametrize('method', ['nearest', 'linear', 'cubic'])
@pytest.mark.parametrize('h,w,oh,ow', [(96, 128, 64, 64), (93, 121, 96, 128),
                                       (40, 30, 77, 50)])
def test_resize_matches_jax(method, h, w, oh, ow):
    rng = np.random.RandomState(h + w)
    img = rng.randint(0, 255, (3, h, w)).astype(np.float32)
    want = np.asarray(JR.resize(jnp.asarray(img), oh, ow, method))
    got = TR.resize(torch.from_numpy(img), oh, ow, method).numpy()
    assert got.shape == want.shape == (3, oh, ow)
    if method == 'nearest':
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            TR.resize_nearest(torch.from_numpy(img), oh, ow).numpy(), want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * 255)


def test_closest_int_multiple_equal():
    for n in range(0, 700, 7):
        for m in (8, 32):
            assert get_closest_int_multiple_of(n, m) == j_closest(n, m)


# ---- morphology ------------------------------------------------------------


def test_dilation_and_bordering_equal():
    rng = np.random.RandomState(0)
    for seed in range(3):
        image, masks, _ = scene(seed, n=6)
        masks[0] = rng.randint(0, 2, masks.shape[1:])   # ragged blob
        np.testing.assert_array_equal(
            TM.binary_dilation(torch.from_numpy(masks)).numpy(),
            np.asarray(JM.binary_dilation(jnp.asarray(masks))))
        np.testing.assert_array_equal(
            TM.bordering_matrix(torch.from_numpy(masks).to(torch.uint8))
            .numpy(),
            np.asarray(JM.bordering_matrix(jnp.asarray(masks))))
    # a single touching pixel pair, and an isolated mask
    m = np.zeros((3, 20, 20), np.float32)
    m[0, 2:8, 2:8] = 1
    m[1, 8, 7] = 1
    m[2, 15:18, 15:18] = 1
    got = TM.bordering_matrix(torch.from_numpy(m)).numpy()
    np.testing.assert_array_equal(got,
                                  np.asarray(JM.bordering_matrix(m)))
    assert got[0, 1] and got[1, 0] and not got[0, 2] and not got.diagonal().any()


# ---- the per-roi pair-batch functions ---------------------------------------


@pytest.mark.parametrize('method', ['cubic', 'linear'])
def test_linear_and_cubic_taps_equal(method):
    _, _, bboxes = scene(1)
    pidx, _ = JP.all_pair_indices(5)
    rois = np.asarray(JP.pair_rois(jnp.asarray(bboxes), jnp.asarray(pidx)))
    adv = np.array([[-30, -20, 200, 200], [100, 80, 1, 1], [5, 7, 33.7, 33.7],
                    [130, -10, 64, 64]], np.float32)
    r = np.concatenate([rois, adv])
    jt = JP._cubic_taps if method == 'cubic' else JP._linear_taps
    tt = TP._cubic_taps if method == 'cubic' else TP._linear_taps
    for off, size, src in ((r[:, 0], r[:, 2], 128), (r[:, 1], r[:, 3], 96)):
        got = tt(torch.from_numpy(off), torch.from_numpy(size), OUT, src)
        for k in range(len(off)):
            want = jt(jnp.float32(off[k]), jnp.float32(size[k]), OUT, src)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g[k].numpy(), np.asarray(w))


@pytest.mark.parametrize('method', ['cubic', 'linear'])
def test_build_pair_batch_rois_matches_jax(method):
    image, masks, bboxes = scene(2)
    pidx, _ = JP.all_pair_indices(5, 16)
    rois = np.array(JP.pair_rois(jnp.asarray(bboxes), jnp.asarray(pidx)))
    rois[-2:] = [[-40, -30, 200, 200], [120, 90, 33.7, 33.7]]
    want = np.asarray(JP.build_pair_batch_rois(
        jnp.asarray(image), jnp.asarray(masks), jnp.asarray(pidx),
        jnp.asarray(rois), out_size=OUT, rgb_method=method))
    got = TP.build_pair_batch_rois(
        torch.from_numpy(image), torch.from_numpy(masks), pidx,
        torch.from_numpy(rois), out_size=OUT, rgb_method=method).numpy()
    assert got.shape == want.shape == (16, OUT, OUT, 5)
    assert_prep_close(got, want, LSB_F32)


def test_build_pair_batch_matches_jax():
    image, masks, bboxes = scene(3, h=93, w=121)
    pidx, _ = JP.all_pair_indices(5, 16)
    want = np.asarray(JP.build_pair_batch(
        jnp.asarray(image), jnp.asarray(masks), jnp.asarray(bboxes),
        jnp.asarray(pidx), out_size=OUT))
    got = TP.build_pair_batch(
        torch.from_numpy(image), torch.from_numpy(masks).to(torch.uint8),
        torch.from_numpy(bboxes), pidx, out_size=OUT).numpy()
    assert_prep_close(got, want, LSB_F32)


@pytest.mark.parametrize('method', ['cubic', 'linear'])
def test_build_pair_batch_shared_rgb_matches_jax(method):
    image, masks, _ = scene(4, h=93, w=121)
    pidx, _ = JP.all_pair_indices(5, 16)
    want = np.asarray(JP.build_pair_batch_shared_rgb(
        jnp.asarray(image), jnp.asarray(masks), jnp.asarray(pidx),
        out_size=OUT, rgb_method=method))
    got = TP.build_pair_batch_shared_rgb(
        torch.from_numpy(image), torch.from_numpy(masks), pidx,
        out_size=OUT, rgb_method=method).numpy()
    assert_prep_close(got, want, LSB_F32)


# ---- row 1'': the 5-channel prep with f32 output ----------------------------


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


@pytest.mark.parametrize('passes', [1, 3])
def test_prep_f32_out_matches_pallas_f32(passes):
    """fused_prep_pairs_plain(out_dtype=f32) against the JAX kernel's f32
    output in interpret mode; the bf16 mode is the f32 mode rounded."""
    images, masks, pidx, rois = _prep_scenes(5 + passes)
    want = j_fused(jnp.asarray(images), jnp.asarray(masks),
                   jnp.asarray(pidx), jnp.asarray(rois), out_size=OUT,
                   passes=passes, out_dtype=jnp.float32, interpret=True)
    want = np.transpose(np.asarray(want), (0, 2, 3, 1))
    args = (torch.from_numpy(images), torch.from_numpy(masks), pidx,
            torch.from_numpy(rois))
    got = PK.fused_prep_pairs(*args, out_size=OUT, passes=passes,
                              out_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == (12, OUT, OUT, 5)
    got = got.numpy()
    assert set(np.unique(got[..., :2])) <= {0.0, 1.0}
    assert_prep_close(got, want, LSB_F32)
    b16 = PK.fused_prep_pairs(*args, out_size=OUT, passes=passes)
    assert b16.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        b16.float().numpy(),
        torch.from_numpy(got).bfloat16().float().numpy())
    with pytest.raises(ValueError, match='out_dtype'):
        PK.fused_prep_pairs(*args, out_size=OUT, out_dtype=torch.float16)


def test_prep_f32_out_through_pair_batches_fused():
    images, masks, pidx, rois = _prep_scenes(9)
    x = TP.build_pair_batches_fused(
        torch.from_numpy(images), torch.from_numpy(masks), pidx,
        torch.from_numpy(rois), out_size=OUT, passes=3, fuse_masks=True,
        dtype=torch.float32)
    assert x.dtype == torch.float32
    np.testing.assert_array_equal(
        x.numpy(), PK.fused_prep_pairs_plain(
            torch.from_numpy(images), torch.from_numpy(masks), pidx,
            torch.from_numpy(rois), out_size=OUT, passes=3,
            out_dtype=torch.float32).numpy())
    # the RGB-kernel route writes f32 too (kernel 5's f32 mode): the
    # same masks, and the RGB kernel's plain f32 values
    rgb = TP.build_pair_batches_fused(
        torch.from_numpy(images), torch.from_numpy(masks), pidx,
        torch.from_numpy(rois), out_size=OUT, dtype=torch.float32)
    assert rgb.dtype == torch.float32
    np.testing.assert_array_equal(rgb[..., :2].numpy(), x[..., :2].numpy())
    np.testing.assert_array_equal(
        rgb[..., 2:].numpy(), PK.fused_prep_rgb_plain(
            torch.from_numpy(images), torch.from_numpy(rois), out_size=OUT,
            passes=3, out_dtype=torch.float32).numpy())


# ---- decode and buckets -----------------------------------------------------


@pytest.mark.parametrize('classes', [3, 4])
@pytest.mark.parametrize('two', [True, False])
def test_decode_ordernet_equal(classes, two):
    rng = np.random.RandomState(classes + 2 * two)
    o1 = rng.randn(40, classes).astype(np.float32) * 3
    o2 = rng.randn(40, classes).astype(np.float32) * 3 if two else None
    want = JD.decode_ordernet(jnp.asarray(o1),
                              None if o2 is None else jnp.asarray(o2))
    got = TD.decode_ordernet(torch.from_numpy(o1),
                             None if o2 is None else torch.from_numpy(o2))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize('two', [True, False])
def test_decode_depth_and_depth_matrix_equal(two):
    rng = np.random.RandomState(7 + two)
    n = 7
    pidx, valid = JP.all_pair_indices(n, 32)
    valid[3] = False
    o1 = rng.randn(32, 3).astype(np.float32) * 3
    o2 = rng.randn(32, 3).astype(np.float32) * 3 if two else None
    want = JD.decode_depth(jnp.asarray(o1),
                           None if o2 is None else jnp.asarray(o2))
    got = TD.decode_depth(torch.from_numpy(o1),
                          None if o2 is None else torch.from_numpy(o2))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert set(np.asarray(want)) == {0, 1, 2}
    np.testing.assert_array_equal(
        TD.depth_matrix(n, pidx, got, valid).numpy(),
        np.asarray(JD.depth_matrix(n, jnp.asarray(pidx), want,
                                   jnp.asarray(valid))))


def test_buckets_equal():
    for p in range(0, 3001):
        assert TPL.bucket_pairs(p) == JPL.bucket_pairs(p)
        assert TPL.bucket_hw(p) == JPL.bucket_hw(p)
    assert TPL.PAIR_BUCKETS == JPL.PAIR_BUCKETS
    assert TPL.HW_BUCKET_STEP == JPL.HW_BUCKET_STEP
    x = np.random.RandomState(0).randn(3, 4, 4, 5).astype(np.float32)
    np.testing.assert_array_equal(
        TPL._swap_input(torch.from_numpy(x)).numpy(),
        np.asarray(JPL._swap_input(jnp.asarray(x))))
