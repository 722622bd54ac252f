"""A model of the CUDA prep kernel's schedule (csrc/prep.cu) against the
plain versions, on the CPU.

The kernel computes each stage-1 value (one source row's horizontal
tap sum at one output column) once per band of output rows: a ring of
four values per column, slot a holding the unclamped tap index
t = y0 - 1 + a, shifted by the move of the tap start y0 from one output
row to the next. Each group of rows is staged and written as one
contiguous range of the NHWC output (one range per row when the columns
are split into tiles). `_schedule` below walks the same blocks, ring,
groups and ranges in PyTorch, with the plain versions' tap tables and
sums, and must equal `fused_prep_pairs_plain` / `fused_prep_rgb_plain`
on every value: the ring changes how often a stage-1 value is computed,
never its arithmetic. Rois are adversarial: crops of 1, 2, 3, out/2,
out, 3*out and 5*out pixels, negative offsets, a roi wholly outside the
image, odd image sizes, out not a multiple of the band."""

import math

import numpy as np
import pytest
import torch

from instaorder_tpu_torch.ops import pairs as TP
from instaorder_tpu_torch.ops import prep_kernels as PK
import torch_threads  # noqa: F401 (the suite's torch thread cap)

OUT = 20
H, W = 37, 29
KERNEL_TILE = PK.TILE_COLS


def _geometry(out_size, channels, band, tile):
    """The launch geometry of csrc/prep.cu `launch`: (ntiles, nbands,
    stage row elements, group rows, shared-memory bytes of the stage)."""
    ntiles = -(-out_size // tile)
    nbands = -(-out_size // band)
    row_elems = (out_size * channels if ntiles == 1
                 else -(-tile * channels // 8) * 8 + 8)
    group = max(1, min(band, 20480 // (row_elems * 2)))
    return ntiles, nbands, row_elems, group, (group * row_elems + 8) * 2


def _tap_start(off, size, out_size):
    """x0 of every output index: the expression of the tap tables
    (prep_kernels._merged_cubic_taps, csrc/prep.cu cubic_taps)."""
    d = torch.arange(out_size, dtype=torch.float32)
    return torch.floor((d + 0.5) * size / out_size - 0.5).long()


def _src_of_tap(t, size, off, src_size):
    """The source index an unclamped tap index t reads."""
    t = torch.as_tensor(float(t), dtype=torch.float32)
    c = torch.minimum(torch.clamp(t, min=0.0), torch.floor(size - 1.0))
    return int(torch.clamp(c + off, 0, src_size - 1).long())


def _rois():
    """(2, 9, 4) xywh: the adversarial crops on scene 0, the same sizes
    at other offsets on scene 1."""
    o = OUT
    r0 = [[3, 4, 1, 1], [-1, 7, 2, 2], [27, -2, 3, 3], [5, 9, o // 2, o // 2],
          [-6, -5, o, o], [-20, -11, 3 * o, 3 * o], [-30, -40, 5 * o, 5 * o],
          [W + 5, -300, o, o], [3, 2, 7, 45]]
    r1 = [[x + 2 * i - 5, y - i, sx, sy] for i, (x, y, sx, sy) in
          enumerate(r0)]
    return torch.tensor([r0, r1], dtype=torch.float32)


def _scenes(seed):
    rng = np.random.RandomState(seed)
    images = torch.from_numpy(
        rng.randint(0, 256, (2, H, W, 3)).astype(np.float32))
    masks = torch.from_numpy(rng.randint(0, 2, (2, 4, H, W)).astype(np.uint8))
    pidx = torch.from_numpy(rng.randint(0, 4, (9, 2)).astype(np.int32))
    return images, masks, pidx, _rois()


def _stage1(img, row, ix, wx, passes):
    """One source row's horizontal sum at the given columns, in tap
    order (the plain version's `_seq_sum4(g * wx)`)."""
    g = img[row][ix].permute(0, 2, 1)                   # (cols, 3, 4)
    s1 = TP._seq_sum4(g * wx[:, None, :])
    return s1.bfloat16().float() if passes == 1 else s1


def _schedule(images, masks, pidx, rois, out_size, passes, normalize,
              band, tile, five, stats=None):
    """The kernel's schedule in PyTorch -> flat (S*P*out*out*C,) bf16.
    stats, if given, collects per block (nrows, stage-1 rows computed,
    the crop's y size)."""
    C = 5 if five else 3
    S, Hs, Ws, _ = images.shape
    P = rois.shape[1]
    ntiles, nbands, _, group, _ = _geometry(out_size, C, band, tile)
    flat = torch.full((S * P * out_size * out_size * C,), float('nan'),
                      dtype=torch.bfloat16)
    mean = torch.as_tensor(TP.IMAGENET_MEAN)
    std = torch.as_tensor(TP.IMAGENET_STD)
    for s in range(S):
        img = images[s].float()
        for p in range(P):
            pp = s * P + p
            r = rois[s, p]
            iy, wy = (a[0] for a in PK._merged_cubic_taps(
                r[1:2], r[3:4], out_size, Hs, passes))
            ix, wx = (a[0] for a in PK._merged_cubic_taps(
                r[0:1], r[2:3], out_size, Ws, passes))
            y0 = _tap_start(r[1], r[3], out_size)
            ny, vy = (a[0] for a in TP._nearest_taps(r[1:2], r[3:4],
                                                     out_size, Hs))
            nx, vx = (a[0] for a in TP._nearest_taps(r[0:1], r[2:3],
                                                     out_size, Ws))
            # pair-major blocks: tile fastest, then band
            for blk in range(nbands * ntiles):
                i0 = (blk // ntiles) * band
                j0 = (blk % ntiles) * tile
                nrows = min(band, out_size - i0)
                cols = slice(j0, min(j0 + tile, out_size))
                ring, ring_t, cur, computed = [None] * 4, [None] * 4, None, 0
                for g0 in range(0, nrows, group):
                    rows = []
                    for i in range(i0 + g0, i0 + min(g0 + group, nrows)):
                        y = int(y0[i])
                        adv = None if cur is None else y - cur
                        k = 0 if adv is None or not 0 <= adv < 4 else 4 - adv
                        cur = y
                        for k in range(k, 4):
                            ring = ring[1:] + [_stage1(
                                img, iy[i, k], ix[cols], wx[cols], passes)]
                            ring_t = ring_t[1:] + [y - 1 + k]
                            computed += 1
                        # slot a holds t = y0 - 1 + a, and t alone names
                        # the source row the plain tap table reads
                        assert ring_t == [y - 1 + a for a in range(4)]
                        assert [_src_of_tap(t, r[3], r[1], Hs)
                                for t in ring_t] == iy[i].tolist()
                        g2 = torch.stack(ring, -1)              # (cols, 3, 4)
                        rgb = torch.clamp(torch.round(TP._seq_sum4(
                            g2 * wy[i])), 0.0, 255.0)
                        if normalize:
                            rgb = (rgb / 255.0 - mean) / std
                        px = [rgb]
                        if five:
                            live = vy[i] & vx[cols]
                            m = [masks[s, int(pidx[p, ch])][ny[i], nx[cols]]
                                 .float() * live for ch in (0, 1)]
                            px = [m[0][:, None], m[1][:, None], rgb]
                        rows.append(torch.cat(px, -1).bfloat16())
                    # the group's stage -> its contiguous range(s) of out
                    e0 = ((pp * out_size + i0 + g0) * out_size + j0) * C
                    if ntiles == 1:
                        st = torch.stack(rows).reshape(-1)
                        assert torch.isnan(flat[e0:e0 + st.numel()]
                                           .float()).all()
                        flat[e0:e0 + st.numel()] = st
                    else:
                        for rr, row in enumerate(rows):
                            e = e0 + rr * out_size * C
                            flat[e:e + row.numel()] = row.reshape(-1)
                if stats is not None:
                    stats.append((nrows, computed, float(r[3])))
    return flat


def _equal(got, want):
    assert not torch.isnan(got.float()).any(), 'a range left unwritten'
    assert got.shape == want.shape
    assert torch.equal(got.float(), want.float())


@pytest.mark.parametrize('passes', [1, 3])
@pytest.mark.parametrize('band,tile', [(PK.BAND_ROWS, KERNEL_TILE), (8, 256),
                                       (7, 8), (3, 6)])
def test_schedule_matches_fused_prep_pairs_plain(passes, band, tile):
    images, masks, pidx, rois = _scenes(1)
    want = PK.fused_prep_pairs_plain(images, masks, pidx, rois,
                                     out_size=OUT, passes=passes)
    got = _schedule(images, masks, pidx, rois, OUT, passes, True, band,
                    tile, five=True)
    _equal(got.reshape(want.shape), want)


@pytest.mark.parametrize('passes,normalize', [(1, True), (3, True),
                                              (1, False), (3, False)])
@pytest.mark.parametrize('band,tile', [(PK.BAND_ROWS, KERNEL_TILE), (7, 8)])
def test_schedule_matches_fused_prep_rgb_plain(passes, normalize, band,
                                               tile):
    images, _, _, rois = _scenes(2)
    want = PK.fused_prep_rgb_plain(images, rois, out_size=OUT,
                                   normalize=normalize, passes=passes)
    got = _schedule(images, None, None, rois, OUT, passes, normalize, band,
                    tile, five=False)
    _equal(got.reshape(want.shape), want)


@pytest.mark.parametrize('out_size', [1, 7, 20, 72, 256])
def test_tap_start_non_decreasing(out_size):
    """The invariant the ring rests on: x0 never decreases along the
    output index, for every crop size from 1 to 5 * out (+ fractions)."""
    for size in np.concatenate([np.arange(1, 5 * out_size + 2),
                                np.arange(1, 40) + 0.37]):
        x0 = _tap_start(0.0, torch.tensor(size, dtype=torch.float32),
                        out_size)
        assert bool((x0[1:] >= x0[:-1]).all()), size


def test_stage1_rows_per_band():
    """Reuse where crops are small, none above 4 * out: a block of n rows
    computes at most n + 3 stage-1 rows when the crop is no larger than
    the output, about n * crop/out + 3 up to 4 * out, and exactly 4 n
    when the crop is above 4 * out."""
    images, masks, pidx, rois = _scenes(3)
    stats = []
    _schedule(images, masks, pidx, rois, OUT, 3, True, 8, 256, five=True,
              stats=stats)
    seen = set()
    for nrows, computed, size in stats:
        scale = size / OUT
        if scale <= 1:
            assert computed <= nrows + 3
            seen.add('small')
        elif scale > 4:
            assert computed == 4 * nrows
            seen.add('no reuse')
        else:
            assert computed <= math.ceil(nrows * scale) + 4
            assert computed < 4 * nrows
            seen.add('reuse')
    assert seen == {'small', 'reuse', 'no reuse'}


@pytest.mark.parametrize('channels', [3, 5])
@pytest.mark.parametrize('out_size', [1, 20, 72, 255, 256, 257, 1000])
def test_output_ranges_cover_out_once(channels, out_size):
    """Every block's group ranges tile the NHWC output of a pair exactly
    once, and the stage fits the kernel's shared-memory budget."""
    band = PK.BAND_ROWS
    ntiles, nbands, row_elems, group, smem = _geometry(
        out_size, channels, band, KERNEL_TILE)
    assert smem <= 20480 + 16 + row_elems * 2 and smem < 48 * 1024
    hits = np.zeros(out_size * out_size * channels, np.int32)
    for blk in range(nbands * ntiles):
        i0 = (blk // ntiles) * band
        j0 = (blk % ntiles) * KERNEL_TILE
        nrows = min(band, out_size - i0)
        ncols = min(KERNEL_TILE, out_size - j0)
        for g0 in range(0, nrows, group):
            gn = min(group, nrows - g0)
            e0 = ((i0 + g0) * out_size + j0) * channels
            if ntiles == 1:
                hits[e0:e0 + gn * out_size * channels] += 1
            else:
                assert ncols * channels + 7 <= row_elems
                for rr in range(gn):
                    e = e0 + rr * out_size * channels
                    hits[e:e + ncols * channels] += 1
    assert (hits == 1).all()
