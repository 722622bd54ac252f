"""COCO-compatible run-length-encoding codec (numpy; counterpart of
instaorder_tpu/data/rle.py, copied whole).

The reference depends on pycocotools' C codec for every mask it touches
(reference datasets/reader.py:20-66). This module provides the same wire
formats without that dependency:

  * compressed RLE strings (the `{"size": [h, w], "counts": "<ascii>"}` form)
  * uncompressed RLE (`counts` as a list of ints)
  * polygon -> RLE rasterisation (bit-exact port of pycocotools' upsample-
    by-5 boundary algorithm, so decoded masks match pycocotools exactly)
  * merge (union/intersection), area, bbox

Runs are column-major (Fortran order); counts alternate 0-runs / 1-runs
starting with the number of leading zeros. When the port's C++ codec
(`instaorder_tpu_torch/native`) has been built and loaded, the hot paths
are delegated to it through `_NATIVE`.
"""

from __future__ import annotations

import numpy as np

# Populated by the port's `native.load()` when the C++ codec is available;
# each entry maps name -> callable with the same signature.
_NATIVE = {}


# ---------------------------------------------------------------------------
# compressed-string <-> counts
# ---------------------------------------------------------------------------

def string_to_counts(s) -> np.ndarray:
    """Decode COCO's ascii-packed counts (5-bit groups, delta-coded)."""
    if isinstance(s, str):
        s = s.encode('ascii')
    if 'string_to_counts' in _NATIVE:
        return _NATIVE['string_to_counts'](s)
    counts = []
    p = 0
    n = len(s)
    while p < n:
        x = 0
        k = 0
        while True:
            c = s[p] - 48
            x |= (c & 0x1F) << (5 * k)
            p += 1
            k += 1
            if not (c & 0x20):
                if c & 0x10:  # sign-extend
                    x |= -1 << (5 * k)
                break
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return np.asarray(counts, dtype=np.int64)


def counts_to_string(counts) -> str:
    """Encode counts into COCO's ascii packing (inverse of above)."""
    counts = np.asarray(counts, dtype=np.int64)
    out = bytearray()
    for i in range(len(counts)):
        x = int(counts[i])
        if i > 2:
            x -= int(counts[i - 2])
        while True:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(c + 48)
            if not more:
                break
    return out.decode('ascii')


# ---------------------------------------------------------------------------
# decode / encode
# ---------------------------------------------------------------------------

def _counts_of(rle) -> np.ndarray:
    c = rle['counts']
    if isinstance(c, (bytes, str)):
        return string_to_counts(c)
    return np.asarray(c, dtype=np.int64)


def decode(rle) -> np.ndarray:
    """RLE dict {'size': [h, w], 'counts': str|list} -> HxW uint8 mask."""
    h, w = rle['size']
    counts = _counts_of(rle)
    if 'decode_counts' in _NATIVE:
        return _NATIVE['decode_counts'](counts, int(h), int(w))
    total = int(counts.sum())
    assert total == h * w, f"rle length {total} != {h}*{w}"
    flat = np.zeros(total, dtype=np.uint8)
    ends = np.cumsum(counts)
    starts = ends - counts
    # odd-indexed runs are foreground
    for s, e in zip(starts[1::2], ends[1::2]):
        flat[s:e] = 1
    return flat.reshape((w, h)).T  # column-major


def encode(mask: np.ndarray) -> dict:
    """HxW {0,1} mask -> compressed RLE dict."""
    h, w = mask.shape
    flat = np.asarray(mask, dtype=np.uint8).T.reshape(-1)  # column-major
    if flat.size == 0:
        return {'size': [h, w], 'counts': counts_to_string([0])}
    change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    bounds = np.concatenate(([0], change, [flat.size]))
    counts = np.diff(bounds)
    if flat[0] == 1:  # first run must be a 0-run
        counts = np.concatenate(([0], counts))
    return {'size': [int(h), int(w)], 'counts': counts_to_string(counts)}


def area(rle) -> int:
    counts = _counts_of(rle)
    return int(counts[1::2].sum())


def to_bbox(rle):
    """xywh bbox of an RLE (same semantics as pycocotools rleToBbox)."""
    m = decode(rle)
    ys, xs = np.nonzero(m)
    if len(xs) == 0:
        return [0.0, 0.0, 0.0, 0.0]
    x0, x1 = xs.min(), xs.max()
    y0, y1 = ys.min(), ys.max()
    return [float(x0), float(y0), float(x1 - x0 + 1), float(y1 - y0 + 1)]


# ---------------------------------------------------------------------------
# polygon -> RLE (bit-exact pycocotools rleFrPoly port)
# ---------------------------------------------------------------------------

def from_polygon(xy, h: int, w: int) -> dict:
    """Rasterise one polygon (flat [x0,y0,x1,y1,...]) into compressed RLE.

    Follows pycocotools' algorithm: scale coords by 5, walk every boundary
    pixel with a DDA, keep the left-edge crossings, downsample, then turn
    the sorted crossing positions into alternating runs. Bit-exact with
    maskUtils.frPyObjects for a single polygon.
    """
    xy = np.asarray(xy, dtype=np.float64)
    if 'polygon_to_counts' in _NATIVE:
        counts = _NATIVE['polygon_to_counts'](xy, int(h), int(w))
        return {'size': [int(h), int(w)],
                'counts': counts_to_string(counts)}
    k = len(xy) // 2
    scale = 5.0
    x = np.floor(scale * xy[0::2] + 0.5).astype(np.int64)
    y = np.floor(scale * xy[1::2] + 0.5).astype(np.int64)
    x = np.concatenate([x, x[:1]])
    y = np.concatenate([y, y[:1]])

    us, vs = [], []
    for j in range(k):
        xs, xe, ys, ye = int(x[j]), int(x[j + 1]), int(y[j]), int(y[j + 1])
        dx, dy = abs(xe - xs), abs(ys - ye)
        flip = (dx >= dy and xs > xe) or (dx < dy and ys > ye)
        if flip:
            xs, xe = xe, xs
            ys, ye = ye, ys
        if dx >= dy:
            s = (ye - ys) / dx if dx > 0 else 0.0
            d = np.arange(dx + 1)
            t = (dx - d) if flip else d
            us.append(t + xs)
            vs.append(np.floor(ys + s * t + 0.5).astype(np.int64))
        else:
            s = (xe - xs) / dy if dy > 0 else 0.0
            d = np.arange(dy + 1)
            t = (dy - d) if flip else d
            vs.append(t + ys)
            us.append(np.floor(xs + s * t + 0.5).astype(np.int64))
    u = np.concatenate(us)
    v = np.concatenate(vs)

    # keep left-edge crossings, downsample by `scale`
    xs_out, ys_out = [], []
    for j in range(1, len(u)):
        if u[j] == u[j - 1]:
            continue
        xd = float(u[j] if u[j] < u[j - 1] else u[j] - 1)
        xd = (xd + 0.5) / scale - 0.5
        if np.floor(xd) != xd or xd < 0 or xd > w - 1:
            continue
        yd = float(v[j] if v[j] < v[j - 1] else v[j - 1])
        yd = (yd + 0.5) / scale - 0.5
        yd = min(max(yd, 0.0), float(h))
        ys_out.append(int(np.ceil(yd)))
        xs_out.append(int(xd))

    a = np.array([xx * h + yy for xx, yy in zip(xs_out, ys_out)]
                 + [h * w], dtype=np.int64)
    a.sort()
    a = np.diff(np.concatenate(([0], a)))
    # collapse zero deltas (pairs of crossings at the same position toggle
    # twice -> merge into the previous run)
    b = []
    j = 0
    m = len(a)
    b.append(int(a[0]))
    j = 1
    while j < m:
        if a[j] > 0:
            b.append(int(a[j]))
            j += 1
        else:
            j += 1
            if j < m:
                b[-1] += int(a[j])
                j += 1
    return {'size': [int(h), int(w)], 'counts': counts_to_string(b)}


def fr_poly_objects(segm, h: int, w: int):
    """pycocotools.frPyObjects semantics for the inputs the readers use:
    list-of-polygons -> list of RLEs; uncompressed-RLE dict -> compressed.
    """
    if isinstance(segm, dict):
        counts = np.asarray(segm['counts'], dtype=np.int64)
        return {'size': list(segm['size']),
                'counts': counts_to_string(counts)}
    return [from_polygon(p, h, w) for p in segm]


def merge(rles, intersect: bool = False) -> dict:
    """Union (or intersection) of RLEs -> one compressed RLE."""
    if isinstance(rles, dict):
        return rles
    if len(rles) == 1:
        r = rles[0]
        if isinstance(r['counts'], (bytes, str)):
            return r
        return {'size': list(r['size']),
                'counts': counts_to_string(np.asarray(r['counts']))}
    acc = decode(rles[0]).astype(bool)
    for r in rles[1:]:
        m = decode(r).astype(bool)
        acc = (acc & m) if intersect else (acc | m)
    return encode(acc.astype(np.uint8))
