"""Checkpoint I/O (counterpart of instaorder_tpu/core/checkpoint.py).

Reads and writes the JAX package's `ckpt_iter_{N}.ckpt` files: a
msgpack map `{step, params, stats[, opt_state]}` as flax's
`serialization.msgpack_serialize` writes it, array leaves as msgpack ext
type 1 (a packed `(shape, dtype.name, C-order bytes)` triple), numpy
scalars as ext type 3, and arrays over 2**30 bytes split into flax's
chunked form (`{'__msgpack_chunked_array__': True, 'shape': ...,
'chunks': ...}`). The codec below covers exactly that subset (maps, str,
int, float, bool, nil, arrays, bin and the two ext types; dtypes numpy
knows, so no bfloat16) in Python with
`struct`, so neither flax nor the msgpack package is needed: the same
tree gives the same bytes as flax, dict keys sorted as JAX's tree_map
sorts them. Leaves come in as numpy arrays (tensors are converted) and
go out as numpy arrays; `convert.to_torch` moves a loaded tree to a
device. Loading is lenient like the reference's strict=False: missing
keys keep their initialised values, with warnings.
"""

from __future__ import annotations

import os
import re
import struct
from typing import Optional

import numpy as np
import torch

# flax.serialization: chunk array leaves above this many bytes
MAX_CHUNK_SIZE = 2 ** 30
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_CHUNKED = '__msgpack_chunked_array__'


# ---------------------------------------------------------------------------
# msgpack: the subset flax writes
# ---------------------------------------------------------------------------

def _pack_int(v: int, out: bytearray):
    if -32 <= v < 128:
        out += struct.pack('b' if v < 0 else 'B', v)
    elif v >= 0:
        for lim, code, fmt in ((1 << 8, 0xcc, '>B'), (1 << 16, 0xcd, '>H'),
                               (1 << 32, 0xce, '>I'), (1 << 64, 0xcf, '>Q')):
            if v < lim:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f'int {v} does not fit msgpack')
    else:
        for lim, code, fmt in ((1 << 7, 0xd0, '>b'), (1 << 15, 0xd1, '>h'),
                               (1 << 31, 0xd2, '>i'), (1 << 63, 0xd3, '>q')):
            if v >= -lim:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f'int {v} does not fit msgpack')


def _pack_len(n: int, fix, fix_max, codes, out: bytearray):
    """A length header: a fix form below fix_max, else the 8/16/32-bit
    codes (an 8-bit code may be None)."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    for lim, code, fmt in zip((1 << 8, 1 << 16, 1 << 32), codes,
                              ('>B', '>H', '>I')):
        if code is not None and n < lim:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f'length {n} does not fit msgpack')


def _pack_ext(code: int, data: bytes, out: bytearray):
    n = len(data)
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixed:
        out.append(fixed[n])
    else:
        _pack_len(n, None, 0, (0xc7, 0xc8, 0xc9), out)
    out += struct.pack('b', code)
    out += data


def _ndarray_bytes(a: np.ndarray) -> bytes:
    """flax's `_ndarray_to_bytes`: packb((shape, dtype.name, bytes))."""
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise ValueError('object and structured dtypes are not supported')
    out = bytearray()
    _pack((list(a.shape), a.dtype.name, a.tobytes('C')), out)
    return bytes(out)


def _pack(o, out: bytearray):
    if o is None:
        out.append(0xc0)
    elif o is True:
        out.append(0xc3)
    elif o is False:
        out.append(0xc2)
    elif type(o) is int:
        _pack_int(o, out)
    elif type(o) is float:
        out.append(0xcb)
        out += struct.pack('>d', o)
    elif type(o) is str:
        b = o.encode('utf-8')
        _pack_len(len(b), 0xa0, 32, (0xd9, 0xda, 0xdb), out)
        out += b
    elif type(o) is bytes:
        _pack_len(len(o), None, 0, (0xc4, 0xc5, 0xc6), out)
        out += o
    elif type(o) is dict:
        _pack_len(len(o), 0x80, 16, (None, 0xde, 0xdf), out)
        for k, v in o.items():
            _pack(k, out)
            _pack(v, out)
    elif type(o) in (list, tuple):
        _pack_len(len(o), 0x90, 16, (None, 0xdc, 0xdd), out)
        for v in o:
            _pack(v, out)
    elif isinstance(o, np.ndarray):
        _pack_ext(_EXT_NDARRAY, _ndarray_bytes(o), out)
    elif isinstance(o, np.generic):
        _pack_ext(_EXT_NPSCALAR, _ndarray_bytes(np.asarray(o)), out)
    else:
        raise TypeError(f'cannot serialize {type(o).__name__}')


def _ndarray_from(data) -> np.ndarray:
    shape, name, buf = unpackb(data)
    return np.frombuffer(bytearray(buf), dtype=np.dtype(name)).reshape(shape)


def _ext(code: int, data):
    if code == _EXT_NDARRAY:
        return _ndarray_from(data)
    if code == _EXT_NPSCALAR:
        return _ndarray_from(data)[()]
    raise ValueError(f'msgpack ext type {code} is not supported')


class _Reader:
    def __init__(self, data):
        self.b = memoryview(data)
        self.p = 0

    def take(self, n):
        if self.p + n > len(self.b):
            raise ValueError('truncated msgpack data')
        v = self.b[self.p:self.p + n]
        self.p += n
        return v

    def num(self, fmt):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self):
        c = self.take(1)[0]
        if c <= 0x7f:
            return c
        if c >= 0xe0:
            return c - 0x100
        if 0x80 <= c <= 0x8f:
            return self.map(c & 0x0f)
        if 0x90 <= c <= 0x9f:
            return self.array(c & 0x0f)
        if 0xa0 <= c <= 0xbf:
            return str(self.take(c & 0x1f), 'utf-8')
        if c == 0xc0:
            return None
        if c in (0xc2, 0xc3):
            return c == 0xc3
        fmt = {0xcc: '>B', 0xcd: '>H', 0xce: '>I', 0xcf: '>Q', 0xd0: '>b',
               0xd1: '>h', 0xd2: '>i', 0xd3: '>q', 0xca: '>f', 0xcb: '>d'}
        if c in fmt:
            return self.num(fmt[c])
        lens = {0xc4: '>B', 0xc5: '>H', 0xc6: '>I', 0xd9: '>B', 0xda: '>H',
                0xdb: '>I', 0xc7: '>B', 0xc8: '>H', 0xc9: '>I'}
        if c in (0xc4, 0xc5, 0xc6):
            return bytes(self.take(self.num(lens[c])))
        if c in (0xd9, 0xda, 0xdb):
            return str(self.take(self.num(lens[c])), 'utf-8')
        if c in (0xc7, 0xc8, 0xc9):
            n = self.num(lens[c])
            code = self.num('b')
            return _ext(code, self.take(n))
        if 0xd4 <= c <= 0xd8:
            n = 1 << (c - 0xd4)
            code = self.num('b')
            return _ext(code, self.take(n))
        if c in (0xdc, 0xdd):
            return self.array(self.num('>H' if c == 0xdc else '>I'))
        if c in (0xde, 0xdf):
            return self.map(self.num('>H' if c == 0xde else '>I'))
        raise ValueError(f'msgpack byte 0x{c:02x} is not supported')

    def array(self, n):
        return [self.obj() for _ in range(n)]

    def map(self, n):
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out


def packb(tree) -> bytes:
    """msgpack bytes of a tree of dicts, lists, Python scalars and numpy
    leaves (flax's encoding; dicts are packed in their own key order)."""
    out = bytearray()
    _pack(tree, out)
    return bytes(out)


def unpackb(data):
    r = _Reader(data)
    obj = r.obj()
    if r.p != len(r.b):
        raise ValueError('trailing bytes after msgpack data')
    return obj


# ---------------------------------------------------------------------------
# flax's tree conventions: sorted keys, chunked oversized arrays
# ---------------------------------------------------------------------------

def _host(x):
    """A tensor leaf as a numpy array (other leaves unchanged)."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def _tree(tree, leaf):
    """`leaf` over every leaf, dict keys sorted as JAX's tree_map sorts
    them; lists, tuples and None kept."""
    if isinstance(tree, dict):
        return {k: _tree(tree[k], leaf) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_tree(v, leaf) for v in tree]
    if isinstance(tree, tuple):
        return tuple(_tree(v, leaf) for v in tree)
    return None if tree is None else leaf(tree)


def _asarray(x):
    """JAX's `tree_map(np.asarray, ...)` leaf."""
    return np.asarray(_host(x))


def _chunk(a: np.ndarray) -> dict:
    size = max(1, int(MAX_CHUNK_SIZE / a.dtype.itemsize))
    flat = a.reshape(-1)
    chunks = [flat[i:i + size] for i in range(0, flat.size, size)]
    return {_CHUNKED: True,
            'shape': {str(i): d for i, d in enumerate(a.shape)},
            'chunks': {str(i): c for i, c in enumerate(chunks)}}


def _chunk_leaves(d):
    """flax's `_chunk_array_leaves_in_place` (dicts only, as flax)."""
    if isinstance(d, dict):
        for k, v in d.items():
            if isinstance(v, np.ndarray):
                if v.size * v.dtype.itemsize > MAX_CHUNK_SIZE:
                    d[k] = _chunk(v)
            elif isinstance(v, dict):
                _chunk_leaves(v)
    elif isinstance(d, np.ndarray) and \
            d.size * d.dtype.itemsize > MAX_CHUNK_SIZE:
        return _chunk(d)
    return d


def _unchunk(d: dict) -> np.ndarray:
    shape = tuple(d['shape'][str(i)] for i in range(len(d['shape'])))
    chunks = [d['chunks'][str(i)] for i in range(len(d['chunks']))]
    return np.concatenate(chunks).reshape(shape)


def _unchunk_leaves(d):
    """flax's `_unchunk_array_leaves_in_place`."""
    if isinstance(d, dict):
        if _CHUNKED in d:
            return _unchunk(d)
        for k, v in d.items():
            if isinstance(v, dict) and _CHUNKED in v:
                d[k] = _unchunk(v)
            elif isinstance(v, dict):
                _unchunk_leaves(v)
    return d


def serialize(tree) -> bytes:
    """flax.serialization.msgpack_serialize of a tree (tensor leaves
    become numpy arrays, as flax turns jax arrays into numpy)."""
    return packb(_chunk_leaves(_tree(tree, _host)))


def restore(data: bytes):
    """flax.serialization.msgpack_restore: the tree of `serialize`."""
    return _unchunk_leaves(unpackb(data))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def save_state(folder: str, step: int, params, stats, opt_state=None):
    os.makedirs(folder, exist_ok=True)
    path = os.path.join(folder, f'ckpt_iter_{step}.ckpt')
    blob = {'step': step, 'params': _tree(params, _asarray),
            'stats': _tree(stats, _asarray)}
    if opt_state is not None:
        blob['opt_state'] = _tree(opt_state, _asarray)
    with open(path, 'wb') as f:
        f.write(serialize(blob))
    return path


def _lenient_merge(target, loaded, path='', warn=print):
    """Take loaded values where the tree structure matches; keep target
    leaves (with a warning) where it doesn't — reference's strict=False."""
    if isinstance(target, dict):
        if not isinstance(loaded, dict):
            warn(f'caution: checkpoint missing subtree {path}')
            return target
        out = {}
        for k, v in target.items():
            if k in loaded:
                out[k] = _lenient_merge(v, loaded[k], f'{path}.{k}', warn)
            else:
                warn(f'caution: missing key from checkpoint: {path}.{k}')
                out[k] = v
        return out
    if isinstance(target, (list, tuple)):
        if not isinstance(loaded, (list, tuple)) or \
                len(loaded) != len(target):
            warn(f'caution: checkpoint list mismatch at {path}')
            return target
        merged = [
            _lenient_merge(t, l, f'{path}[{i}]', warn)
            for i, (t, l) in enumerate(zip(target, loaded))]
        return type(target)(merged) if isinstance(target, tuple) else merged
    # leaf
    if loaded is None:
        return target
    if hasattr(target, 'shape') and hasattr(loaded, 'shape') and \
            tuple(target.shape) != tuple(loaded.shape):
        warn(f'caution: shape mismatch at {path}: '
             f'{tuple(loaded.shape)} vs {tuple(target.shape)}')
        return target
    return loaded


def load_state(path: str, params, stats, opt_state=None, warn=print):
    """Returns (step, params, stats, opt_state)."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"=> no checkpoint found at '{path}'")
    with open(path, 'rb') as f:
        blob = restore(f.read())
    step = int(blob.get('step', parse_iter(path) or 0))
    params = _lenient_merge(params, blob.get('params', {}), 'params', warn)
    stats = _lenient_merge(stats, blob.get('stats', {}), 'stats', warn)
    if opt_state is not None and 'opt_state' in blob:
        opt_state = _lenient_merge(opt_state, blob['opt_state'],
                                   'opt_state', warn)
    return step, params, stats, opt_state


def parse_iter(path: str) -> Optional[int]:
    """Resume iteration parsed from the filename, trainer.py:89."""
    m = re.search(r'iter_(\d+)', os.path.basename(path))
    return int(m.group(1)) if m else None


def latest_checkpoint(folder: str) -> Optional[str]:
    if not os.path.isdir(folder):
        return None
    best, best_it = None, -1
    for fn in os.listdir(folder):
        it = parse_iter(fn)
        if it is not None and it > best_it:
            best, best_it = os.path.join(folder, fn), it
    return best
