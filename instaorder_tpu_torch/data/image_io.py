"""Image file I/O without PIL for PNG (the port's stand-in for the JAX
package's `np.array(Image.open(path).convert('RGB'))`,
instaorder_tpu/eval/tester.py:154-155).

`read_rgb` decodes non-interlaced 8-bit PNG (gray, gray + alpha, RGB,
RGBA and palette) with zlib and numpy, all five row filters, and
returns what PIL's `.convert('RGB')` gives: alpha dropped, gray and
palette expanded. Every other file (JPEG, 16-bit or interlaced PNG, ...)
goes through PIL, imported at call time, so a machine without PIL still
reads PNG. `read_depth_png` reads a depth map as the JAX package's
`cv2.imread(name, -1) / 256` gives it (the KITTI convention,
instaorder_tpu/eval/disp.py:88-92): 8- and 16-bit gray PNG decode here,
anything else through cv2 at call time. `write_png` writes RGB or gray
(uint8, or uint16 as 16-bit gray) with filter 0.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_SIGNATURE = b'\x89PNG\r\n\x1a\n'
# channels by PNG colour type: gray, RGB, palette, gray + alpha, RGBA
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack('>I4s', data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc, = struct.unpack('>I', data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f'PNG chunk {kind!r}: CRC mismatch')
        yield kind, body
        pos += 12 + length
        if kind == b'IEND':
            return


def _paeth_row(raw, prior, bpp):
    """Undo the Paeth filter of one row (Python ints: each byte depends on
    the one bpp to its left)."""
    out = bytearray(raw)
    for x in range(len(out)):
        a = out[x - bpp] if x >= bpp else 0
        b = prior[x]
        c = prior[x - bpp] if x >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        out[x] = (out[x] + pred) & 0xFF
    return out


def _average_row(raw, prior, bpp):
    out = bytearray(raw)
    for x in range(len(out)):
        a = out[x - bpp] if x >= bpp else 0
        out[x] = (out[x] + ((a + prior[x]) >> 1)) & 0xFF
    return out


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Reverse the per-row filters of a decompressed 8-bit image."""
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != h * (stride + 1):
        raise ValueError('PNG: image data has the wrong size')
    rows = rows.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            cur = line
        elif kind == 1:     # Sub: a running sum along each byte lane
            lanes = line.reshape(-1, bpp).astype(np.uint32)
            cur = (np.cumsum(lanes, axis=0) & 0xFF).astype(
                np.uint8).reshape(-1)
        elif kind == 2:     # Up
            cur = line + prior
        elif kind == 3:     # Average
            cur = np.frombuffer(_average_row(line.tobytes(),
                                             prior.tobytes(), bpp), np.uint8)
        elif kind == 4:     # Paeth
            cur = np.frombuffer(_paeth_row(line.tobytes(), prior.tobytes(),
                                           bpp), np.uint8)
        else:
            raise ValueError(f'PNG: unknown row filter {kind}')
        out[y] = cur
        prior = out[y]
    return out


def _png_parts(data: bytes):
    """-> (IHDR fields, palette or None, the joined IDAT bytes)."""
    header = palette = None
    idat = []
    for kind, body in _chunks(data):
        if kind == b'IHDR':
            header = struct.unpack('>IIBBBBB', body)
        elif kind == b'PLTE':
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b'IDAT':
            idat.append(body)
    if header is None:
        raise ValueError('PNG without IHDR')
    return header, palette, b''.join(idat)


def _decode_png(data: bytes):
    """-> (H, W, 3) uint8, or None for a PNG this decoder does not cover
    (bit depth other than 8, interlaced)."""
    (w, h, depth, ctype, _, _, interlace), palette, idat = _png_parts(data)
    if depth != 8 or interlace != 0 or ctype not in _CHANNELS:
        return None
    ch = _CHANNELS[ctype]
    pix = _unfilter(zlib.decompress(idat), h, w * ch, ch)
    pix = pix.reshape(h, w, ch)
    if ctype == 3:
        if palette is None:
            raise ValueError('palette PNG without PLTE')
        return palette[pix[..., 0]]
    if ch <= 2:             # gray (+ alpha): replicate, drop alpha
        return np.repeat(pix[..., :1], 3, axis=2)
    return np.ascontiguousarray(pix[..., :3])


def read_rgb(path) -> np.ndarray:
    """(H, W, 3) uint8 RGB of an image file, as PIL's
    `np.array(Image.open(path).convert('RGB'))` gives it."""
    with open(path, 'rb') as f:
        data = f.read()
    if data.startswith(_SIGNATURE):
        img = _decode_png(data)
        if img is not None:
            return img
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f'image_io.read_rgb: {path} is not an 8-bit non-interlaced '
            'PNG, and reading it needs the PIL package (Pillow)') from e
    with Image.open(path) as im:
        return np.array(im.convert('RGB'))


def read_depth_png(path):
    """(H, W) float32 depth of a depth-map file, as the JAX package's
    `cv2.imread(path, -1).astype(np.float32) / 256` gives it (uint16 / 256
    for KITTI's 16-bit PNGs), or None where the file does not exist (as
    cv2.imread gives None)."""
    if not os.path.exists(path):
        return None
    with open(path, 'rb') as f:
        data = f.read()
    raw = None
    if data.startswith(_SIGNATURE):
        (w, h, depth, ctype, _, _, interlace), _, idat = _png_parts(data)
        if ctype == 0 and depth in (8, 16) and interlace == 0:
            nb = depth // 8
            pix = _unfilter(zlib.decompress(idat), h, w * nb, nb)
            raw = pix.view('>u2' if nb == 2 else np.uint8).reshape(h, w)
    if raw is None:
        try:
            import cv2
        except ImportError as e:
            raise ImportError(
                f'image_io.read_depth_png: {path} is not an 8- or 16-bit '
                'gray non-interlaced PNG, and reading it needs cv2') from e
        raw = cv2.imread(path, -1)
        if raw is None:
            return None
    return raw.astype(np.float32) / 256.0


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack('>I', len(body)) + kind + body
            + struct.pack('>I', zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path, arr) -> None:
    """Write an (H, W, 3) RGB or (H, W) gray uint8 array, or an (H, W)
    uint16 array as 16-bit gray, as a PNG (every row filter 0, zlib level
    6)."""
    depth = 16 if np.asarray(arr).dtype == np.uint16 else 8
    a = np.ascontiguousarray(arr, dtype='>u2' if depth == 16 else np.uint8)
    if a.ndim == 2:
        ctype = 0
    elif a.ndim == 3 and a.shape[2] == 3 and depth == 8:
        ctype = 2
    else:
        raise ValueError(f'write_png takes (H, W) or (H, W, 3) uint8 or '
                         f'(H, W) uint16, got {a.shape} {a.dtype}')
    h, w = a.shape[:2]
    rows = a.view(np.uint8).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    with open(path, 'wb') as f:
        f.write(_SIGNATURE)
        f.write(_chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, depth, ctype,
                                            0, 0, 0)))
        f.write(_chunk(b'IDAT', zlib.compress(raw.tobytes(), 6)))
        f.write(_chunk(b'IEND', b''))
