"""Build the port's CUDA sources into one shared library and load it.

Every `csrc/*.cu` is compiled by its own `nvcc -c` process (all started
together), then the objects are linked into one shared library under
`instaorder_tpu_torch/_build/`, named by a hash of the sources and flags:
a changed source builds a new library, an unchanged one is reused. The
library exposes plain C entry points (no PyTorch headers, so each file
compiles in seconds) and is loaded with ctypes. Nothing here runs at
import time; the first kernel launch calls `library()`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / 'csrc'
BUILD_DIR = _PKG / '_build'

# -fmad=false: the prep weights must equal numpy's f32 values bit for bit
# (a contracted FMA can flip a bf16 rounding); the bottleneck and stem
# epilogues follow the unfused f32 order of the reference kernels.
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-O3',
              '-std=c++17', '-Xcompiler', '-fPIC', '-fmad=false',
              '-Xptxas', '-v']

# filled by build(): seconds the last build took (0.0 when reused) and
# the compiler's register / shared-memory report
BUILD_INFO = {'seconds': 0.0, 'log': ''}


def _nvcc() -> str:
    for cand in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
        if cand and Path(cand, 'bin', 'nvcc').exists():
            return str(Path(cand, 'bin', 'nvcc'))
    found = shutil.which('nvcc')
    if not found:
        raise RuntimeError('nvcc not found: the CUDA kernels build on a '
                           'machine with the CUDA toolkit')
    return found


def _sources():
    return sorted(SRC_DIR.glob('*.cu'))


def _digest() -> str:
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for f in sorted(SRC_DIR.glob('*.cu*')):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile (if needed) and return the path of the shared library."""
    lib = BUILD_DIR / f'libinstaorder_kernels_{_digest()}.so'
    if lib.exists():
        BUILD_INFO.update(seconds=0.0, log=f'reused {lib.name}')
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        procs = []
        for src in _sources():
            obj = tmp / (src.stem + '.o')
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, '-c', str(src), '-o', str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs = []
        for src, _obj, proc in procs:
            out, _ = proc.communicate()
            logs.append(f'--- {src.name}\n{out}')
            if proc.returncode:
                raise RuntimeError(f'nvcc failed on {src.name}:\n{out}')
        tmp_lib = tmp / lib.name
        link = subprocess.run(
            [nvcc, '-shared', '-gencode', 'arch=compute_90a,code=sm_90a',
             *[str(o) for _s, o, _p in procs], '-o', str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f'nvcc link failed:\n{link.stdout}')
        os.replace(tmp_lib, lib)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    BUILD_INFO.update(seconds=time.perf_counter() - t0,
                      log='\n'.join(logs))
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, with every entry point's signature
    declared (pointers and the stream as c_void_p)."""
    lib = ctypes.CDLL(str(build()))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # images, masks, pair_idx, rois, out, S, P, N, H, W, out_size, passes,
    # band rows, f32 out, stream
    lib.io_prep_pairs.argtypes = [P, P, P, P, P, I, I, I, I, I, I, I, I, I,
                                  P]
    lib.io_prep_pairs.restype = I
    # images, rois, out, S, P, H, W, out_size, passes, normalize, band
    # rows, f32 out, stream
    lib.io_prep_rgb.argtypes = [P, P, P, I, I, I, I, I, I, I, I, I, P]
    lib.io_prep_rgb.restype = I
    # x, pack scratch, kernel weights, bias, out, N, H, W, C, cout, q8,
    # stream
    lib.io_fused_stem.argtypes = [P, P, P, P, P, I, I, I, I, I, I, P]
    lib.io_fused_stem.restype = I
    lib.io_conv_gemm.argtypes = (
        # two K segments: activation, its (K, Cout) bf16 weight rows,
        # is_int8, C, H, W, stride, ksize
        [P, P, I, I, I, I, I, I] * 2
        + [I, I, I, I, I,               # N, Ho, Wo, Cout, tile width
           P, P,                        # bias, second bias (or null)
           P, I, F,                     # identity residual, its dtype, r
           P, I, P])                    # out, epilogue mode, stream
    lib.io_conv_gemm.restype = I
    lib.io_conv_gemm_f32.argtypes = (
        # two K segments: f32 or int8 activation, its split K-major
        # (2, Cout, K) f32 weights, kind (0 f32, 1 int8, 2 f32 exact in
        # TF32), C, H, W, stride, ksize
        [P, P, I, I, I, I, I, I] * 2
        + [I, I, I, I, I,               # N, Ho, Wo, Cout, tile width
           P, P,                        # bias, second bias (or null)
           P, I, F,                     # identity residual, its dtype, r
           P, I, P])                    # out, epilogue mode, stream
    lib.io_conv_gemm_f32.restype = I
    # x, pack scratch, split kernel weights, bias, out, N, H, W, C, cout,
    # q8, stream
    lib.io_fused_stem_f32.argtypes = [P, P, P, P, P, I, I, I, I, I, I, P]
    lib.io_fused_stem_f32.restype = I
    # x, pack scratch, kernel weights, m, b, out, N, H, W, C, cout, stream
    lib.io_fused_stem_s8.argtypes = [P, P, P, P, P, P, I, I, I, I, I, P]
    lib.io_fused_stem_s8.restype = I
    lib.io_conv_gemm_s8.argtypes = (
        # two K segments: int8 activation, its (Cout, K) int8 weight
        # rows, f32 multiplier and bias, C, H, W, stride, ksize
        [P, P, P, P, I, I, I, I, I] * 2
        + [I, I, I, I, I,               # N, Ho, Wo, Cout, tile width
           P, F,                        # identity residual, sxr
           P, I, P])                    # out, epilogue mode, stream
    lib.io_conv_gemm_s8.restype = I
    return lib


def launch(entry: str, dev, *args) -> int:
    """Call the library's entry point `entry` with `args` and the current
    stream of `dev` (a CUDA device), `dev` the current device for the
    call: the runtime launches on the current device whatever device the
    stream belongs to, and the kernels keep their launch state (the
    shared-memory attribute, the stems' grid caps) per current device.
    The device is switched only where another one is current (a switch
    costs host time on every launch). Returns the entry point's CUDA
    error code."""
    import torch
    fn = getattr(library(), entry)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if dev.index == torch.cuda.current_device():
        return fn(*args, stream)
    with torch.cuda.device(dev):
        return fn(*args, stream)


def check(rc: int, what: str):
    if rc:
        raise RuntimeError(f'{what}: CUDA error {rc} at launch')
