"""ctypes bindings for the native C++ RLE codec (counterpart of
instaorder_tpu/native/__init__.py).

`load()` builds `rle_codec.cpp` at first use with the host compiler
(`g++ -O3 -fPIC -shared -std=c++17`, no `-march=native`: the build
directory may travel between machines) into
`instaorder_tpu_torch/_build/librle_codec_<hash>.so`, named by a hash of
the source and flags so a changed source builds anew, loads it and
registers the fast paths into `data.rle._NATIVE`. When the library
cannot be built or loaded, `load()` returns None, `LOAD_ERROR` says why,
and the numpy codec stays in use (the JAX package's semantics).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / 'rle_codec.cpp'
BUILD_DIR = _HERE.parent / '_build'
CXX_FLAGS = ['-O3', '-fPIC', '-shared', '-std=c++17']

_lib = None
# why the last load() returned None (None after a successful load)
LOAD_ERROR = None


def _lib_path() -> Path:
    h = hashlib.sha256(' '.join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f'librle_codec_{h.hexdigest()[:16]}.so'


def _build(path: Path):
    """Compile the codec into `path` (written to a temporary name first,
    then renamed, so a concurrent process never loads a partial file)."""
    cxx = os.environ.get('CXX') or shutil.which('g++')
    if not cxx:
        raise RuntimeError('no C++ compiler (g++) on PATH')
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run([cxx, *CXX_FLAGS, '-o', tmp, str(SOURCE)],
                             capture_output=True, text=True, timeout=120)
        if res.returncode != 0:
            raise RuntimeError(f'{cxx} failed: {res.stderr[-2000:]}')
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load(build_if_missing=True):
    """Load (building if needed) and register the native codec.
    Returns the ctypes library, or None with the reason in LOAD_ERROR."""
    global _lib, LOAD_ERROR
    if _lib is not None:
        return _lib
    try:
        path = _lib_path()
        if not path.exists():
            if not build_if_missing:
                raise RuntimeError(f'{path.name} is not built')
            _build(path)
        lib = ctypes.CDLL(str(path))
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        LOAD_ERROR = f'{type(e).__name__}: {e}'
        return None

    lib.rle_string_to_counts.restype = ctypes.c_int64
    lib.rle_string_to_counts.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
    lib.rle_counts_to_string.restype = ctypes.c_int64
    lib.rle_counts_to_string.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_int64]
    lib.rle_decode_counts.restype = ctypes.c_int
    lib.rle_decode_counts.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8)]
    lib.rle_encode_mask.restype = ctypes.c_int64
    lib.rle_encode_mask.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
    lib.rle_from_polygon.restype = ctypes.c_int64
    lib.rle_from_polygon.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]

    _lib = lib
    LOAD_ERROR = None
    _register()
    return lib


def _i64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _u8p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def string_to_counts(s: bytes) -> np.ndarray:
    buf = np.empty(len(s) + 4, dtype=np.int64)
    n = _lib.rle_string_to_counts(s, len(s), _i64p(buf), buf.size)
    if n < 0:
        raise ValueError('malformed RLE string')
    return buf[:n].copy()


def decode_counts(counts: np.ndarray, h: int, w: int) -> np.ndarray:
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    out = np.empty((h, w), dtype=np.uint8)
    rc = _lib.rle_decode_counts(_i64p(counts), counts.size, h, w, _u8p(out))
    if rc != 0:
        raise ValueError(f'rle length mismatch for {h}x{w}')
    return out


def encode_mask(mask: np.ndarray) -> np.ndarray:
    mask = np.ascontiguousarray(mask, dtype=np.uint8)
    h, w = mask.shape
    buf = np.empty(h * w + 2, dtype=np.int64)
    n = _lib.rle_encode_mask(_u8p(mask), h, w, _i64p(buf), buf.size)
    if n < 0:
        raise ValueError('rle encode overflow')
    return buf[:n].copy()


def polygon_to_counts(xy: np.ndarray, h: int, w: int) -> np.ndarray:
    xy = np.ascontiguousarray(xy, dtype=np.float64)
    k = xy.size // 2
    buf = np.empty(h * w + 2, dtype=np.int64)
    n = _lib.rle_from_polygon(
        xy.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), k, h, w,
        _i64p(buf), buf.size)
    if n < 0:
        raise ValueError('polygon rasterisation overflow')
    return buf[:n].copy()


def _register():
    from ..data import rle
    rle._NATIVE['string_to_counts'] = string_to_counts
    rle._NATIVE['decode_counts'] = decode_counts
    rle._NATIVE['polygon_to_counts'] = polygon_to_counts


def registered() -> bool:
    """True when data.rle routes its hot paths through this codec."""
    from ..data import rle
    return (_lib is not None
            and rle._NATIVE.get('decode_counts') is decode_counts)
