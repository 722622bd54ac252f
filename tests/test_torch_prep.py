"""instaorder_tpu_torch pair geometry and the fused prep's plain version
against the JAX package on the CPU.

Bars: pair_rois and the interpolation matrices exact; prep masks
bit-exact; RGB within one uint8 LSB (one bf16 grid step, 2^-5, after
normalisation) on under 1% of pixels (2% on the hand-built adversarial
rois, as tests/test_prep_pallas.py) — the tools/prep_gate.py bar. The
RGB tolerance is the rounding tie: sums taken in another order can land
an exact .5 on the other side of round()."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from instaorder_tpu.ops import pairs as JP
from instaorder_tpu.ops.prep_pallas import fused_prep_pairs as j_fused

from instaorder_tpu_torch.ops import pairs as TP
from instaorder_tpu_torch.ops import prep_kernels as PK
import torch_threads  # noqa: F401 (the suite's torch thread cap)

OUT = 64


def _scenes(seed, S=2, H=96, W=128, N=4):
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
    return images, masks, bboxes, pidx, rois


def _adversarial(seed=5, H=96, W=128, N=2):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 255, (1, H, W, 3)).astype(np.float32)
    masks = rng.randint(0, 2, (1, N, H, W)).astype(np.float32)
    szmax = float(np.trunc(max(np.sqrt(2.0 * H * W), 1.1 * max(H, W))))
    rois = np.array([[
        [0, 0, szmax, szmax], [-60, -40, szmax, szmax],
        [W - 10, H - 10, szmax, szmax], [-130, 10, 120, 120],
        [30, 20, 2, 2], [10, 5, 1, 1], [5, 7, 33.7, 33.7], [0, 0, W, H],
    ]], np.float32)
    rois[..., :2] = np.trunc(rois[..., :2])
    pidx = np.tile(np.array([[0, 1]], np.int32), (rois.shape[1], 1))
    return images, masks, pidx, rois


def _port(images, masks, pidx, rois, passes):
    return PK.fused_prep_pairs(
        torch.from_numpy(images), torch.from_numpy(masks), pidx,
        torch.from_numpy(rois), out_size=OUT, passes=passes).float().numpy()


def _einsum_ref(images, masks, pidx, rois):
    return np.concatenate([np.asarray(JP.build_pair_batch_matmul(
        jnp.asarray(images[s]), jnp.asarray(masks[s]), jnp.asarray(pidx),
        jnp.asarray(rois[s]), out_size=OUT, dtype=jnp.bfloat16,
        precision=jax.lax.Precision.HIGHEST), np.float32)
        for s in range(images.shape[0])], axis=0)


def _pallas_ref(images, masks, pidx, rois, passes):
    H, W = images.shape[1:3]
    ph, pw = (-H) % 8, (-W) % 8          # the kernel's 8-multiple pad
    images = np.pad(images, ((0, 0), (0, ph), (0, pw), (0, 0)))
    masks = np.pad(masks, ((0, 0), (0, 0), (0, ph), (0, pw)))
    out = j_fused(jnp.asarray(images), jnp.asarray(masks),
                  jnp.asarray(pidx), jnp.asarray(rois), out_size=OUT,
                  passes=passes, interpret=True)
    return np.transpose(np.asarray(out, np.float32), (0, 2, 3, 1))


def _assert_prep_close(got, want, max_frac=0.01):
    np.testing.assert_array_equal(got[..., :2], want[..., :2])
    d = np.abs(got[..., 2:] - want[..., 2:])
    assert d.max() <= 0.03125 + 1e-6, d.max()
    assert (d > 0).mean() < max_frac, (d > 0).mean()


def test_pair_rois_and_indices_exact():
    images, masks, bboxes, pidx, rois = _scenes(0)
    got = TP.pair_rois(torch.from_numpy(bboxes), pidx).numpy()
    np.testing.assert_array_equal(got, rois)
    for n in (0, 1, 5):
        for a, b in zip(TP.all_pair_indices(n, p_max=12),
                        JP.all_pair_indices(n, p_max=12)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('method', ['cubic', 'nearest'])
def test_interp_matrix_exact(method):
    _, _, _, _, rois = _scenes(1)
    adv = _adversarial()[3][0]
    for r in np.concatenate([rois.reshape(-1, 4), adv]):
        for off, size, src in ((r[0], r[2], 128), (r[1], r[3], 96)):
            want = np.asarray(JP._interp_matrix(
                jnp.float32(off), jnp.float32(size), OUT, src, method),
                np.float32)
            got = TP._interp_matrix(torch.tensor([off]), torch.tensor([size]),
                                    OUT, src, method)[0].numpy()
            np.testing.assert_array_equal(got, want)


def test_nearest_and_cubic_taps_exact():
    _, _, _, _, rois = _scenes(3)
    r = np.concatenate([rois.reshape(-1, 4), _adversarial()[3][0]])
    for off, size, src in ((r[:, 0], r[:, 2], 128), (r[:, 1], r[:, 3], 96)):
        t_off, t_size = torch.from_numpy(off), torch.from_numpy(size)
        for k in range(len(off)):
            j_off, j_size = jnp.float32(off[k]), jnp.float32(size[k])
            for got, want in zip(
                    TP._nearest_taps(t_off, t_size, OUT, src),
                    JP._nearest_taps(j_off, j_size, OUT, src)):
                np.testing.assert_array_equal(got[k].numpy(), want)
            for got, want in zip(TP._cubic_taps(t_off, t_size, OUT, src),
                                 JP._cubic_taps(j_off, j_size, OUT, src)):
                np.testing.assert_array_equal(got[k].numpy(), want)


def test_merged_taps_equal_dense_matrix():
    """The kernel's tap weights are the dense matrix's entries: scattering
    them back gives _interp_matrix bit for bit."""
    _, _, _, _, rois = _scenes(2)
    r = torch.from_numpy(np.concatenate([rois.reshape(-1, 4),
                                         _adversarial()[3][0]]))
    for off, size, src in ((r[:, 0], r[:, 2], 128), (r[:, 1], r[:, 3], 96)):
        idx, w = PK._merged_cubic_taps(off, size, OUT, src, passes=3)
        dense = torch.zeros((r.shape[0], OUT, src))
        dense.scatter_add_(2, idx, w)
        want = TP._interp_matrix(off, size, OUT, src)
        np.testing.assert_array_equal(dense.numpy(), want.numpy())


@pytest.mark.parametrize('passes', [3, 1])
def test_prep_plain_matches_pallas_random(passes):
    images, masks, _, pidx, rois = _scenes(4)
    _assert_prep_close(_port(images, masks, pidx, rois, passes),
                       _pallas_ref(images, masks, pidx, rois, passes))


@pytest.mark.parametrize('passes', [3, 1])
def test_prep_plain_matches_pallas_adversarial(passes):
    images, masks, pidx, rois = _adversarial()
    _assert_prep_close(_port(images, masks, pidx, rois, passes),
                       _pallas_ref(images, masks, pidx, rois, passes),
                       max_frac=0.02)


@pytest.mark.parametrize('passes', [3, 1])
def test_prep_plain_matches_pallas_non8_dims(passes):
    images, masks, _, pidx, rois = _scenes(7, H=91, W=107)
    _assert_prep_close(_port(images, masks, pidx, rois, passes),
                       _pallas_ref(images, masks, pidx, rois, passes))


def test_prep_plain_matches_einsum_highest():
    """passes=3 against the cv2-exact dense f32 reference, random and
    adversarial rois, plus the port's own dense reference."""
    images, masks, _, pidx, rois = _scenes(8)
    want = _einsum_ref(images, masks, pidx, rois)
    _assert_prep_close(_port(images, masks, pidx, rois, 3), want)
    own = np.concatenate([TP.build_pair_batch_matmul(
        torch.from_numpy(images[s]), torch.from_numpy(masks[s]), pidx,
        torch.from_numpy(rois[s]), out_size=OUT,
        dtype=torch.bfloat16).float().numpy() for s in range(2)])
    _assert_prep_close(own, want)
    images, masks, pidx, rois = _adversarial()
    _assert_prep_close(_port(images, masks, pidx, rois, 3),
                       _einsum_ref(images, masks, pidx, rois), max_frac=0.02)


def test_build_pair_batches_fused_is_the_prep():
    images, masks, bboxes, pidx, rois = _scenes(9)
    got = TP.build_pair_batches_fused(
        torch.from_numpy(images), torch.from_numpy(masks), pidx,
        TP.pair_rois(torch.from_numpy(bboxes), pidx), out_size=OUT,
        passes=1)
    assert got.shape == (12, OUT, OUT, 5) and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  _port(images, masks, pidx, rois, 1))
