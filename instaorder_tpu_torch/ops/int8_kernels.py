"""Kernels 16, 17, 19, 20, 21: the int8c bottleneck
(csrc/bottleneck_int8.cu), and the exact int8 convolution the plain
versions build on.

Each wrapper replaces TPU kernels of instaorder_tpu/ops/pallas_blocks.py
and takes NHWC (N, H, W, C) int8 activations:

  fused_bottleneck_int8               <- fused_bottleneck_int8
      stride 1, identity residual (the `identity` feature)
  fused_bottleneck_down_int8          <- fused_bottleneck_down_int8
      projection, stride 1 or 2 (the `down` feature)
  fused_bottleneck_int8_hwnc          <- fused_bottleneck_int8_hwnc
  fused_bottleneck_down_int8_hwnc     <- fused_bottleneck_down_int8_hwnc
  fused_bottleneck_down_s2_int8_hwnc  <- fused_bottleneck_down_s2_int8_hwnc
      the `hwnc` route: the TPU kernels compute the same functions on an
      (H, W, N, C) view, which the port does not have, so these wrappers
      launch the same kernel on NHWC and count their own launches.

Math contract (models/quantize.quantize_folded_resnet; the Pallas kernel
bodies and the XLA int8 oracle `_apply_trunk_int8`):
  rq8(acc) = clip(round(f32(acc) * m + b), 0, 127)     per out channel
  h1  = rq8(x . w1)                          s8 x s8 -> s32, exact
  h2  = rq8(conv3x3_s(h1) . w2)              pad 1, stride s
  out = clip(round((acc3 * m3 + b3) + f32(x) * sxr), 0, 127)     identity
  out = clip(round((acc3 * m3 + b3) + (accd * md + bd)), 0, 127) projection
with round half to even, every f32 operation rounded on its own (no
fused multiply-add). The s32 sums are exact, so kernel, plain version and
the JAX package agree bit for bit.

Plain versions: torch has no int8 convolution, so `conv_int8` convolves
in float64 and rounds back to int32. Every partial sum is an integer of
magnitude below K * 127^2 < 2^31 << 2^53, so float64 holds it exactly
whatever algorithm the backend picks, and the final round removes any
fractional residue a transform-domain algorithm could leave. (float32
would be exact only while K * 127^2 < 2^24: true for the 7x7 stem, K =
245, not for a 3x3 at Cm = 512, K = 4,608.) The plain versions split the
batch so that their float64 temporaries stay near 4 GB.

Bound on the H100: int8 tensor-core operations (see the .cu file). The
kernel reads its weights K-major, (Cout, K): `gemm_layout.kmajor` lays
a block's weights out so, once, when the model is built on the card
(models/quantize.add_kernel_weights), and every wrapper takes them as
`wk=`; the JAX-layout weights stay for the plain versions. On CPU
tensors each wrapper runs its `_plain` version; on CUDA tensors it
launches the kernel or raises, and adds one to its `launches` count per
call.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build, gemm_layout

# epilogue modes of csrc/bottleneck_int8.cu
_RQ8, _RESIDUAL, _PROJECTION = 0, 1, 2

# float64 bytes a plain version may hold in one temporary
_PLAIN_BYTES = 1 << 32


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def conv_int8(x8, w8, stride=1, padding=0):
    """Exact int8 x int8 -> int32 NHWC convolution, HWIO weights (the
    JAX package's `_conv_int8`): float64 sums, rounded back to int32."""
    y = F.conv2d(x8.permute(0, 3, 1, 2).double(),
                 w8.permute(3, 2, 0, 1).double(), stride=stride,
                 padding=padding)
    return y.round_().to(torch.int32).permute(0, 2, 3, 1)


def requant(acc, m, b):
    """int32 accumulator -> one-sided int8, clip(round(f32(acc) * m + b),
    0, 127) (the JAX package's `_requant`; its relu is the clip's lower
    bound, since round is monotone)."""
    return acc.float().mul_(m).add_(b).round_().clamp_(0, 127).to(torch.int8)


def batch_chunks(x, per_image):
    """x split on the batch so that a temporary of `per_image` bytes per
    image stays within _PLAIN_BYTES."""
    n = max(1, _PLAIN_BYTES // max(int(per_image), 1))
    return [x[i:i + n] for i in range(0, x.shape[0], n)]


def _block_plain(x, w1, m1, b1, w2, m2, b2, w3, m3, b3, stride=1, sxr=None,
                 wd=None, md=None, bd=None):
    _, H, W, cin = x.shape
    width = max(cin, w1.shape[-1], w3.shape[-1])
    outs = []
    for xc in batch_chunks(x, H * W * width * 8):
        h1 = requant(conv_int8(xc, w1[None, None]), m1, b1)
        h2 = requant(conv_int8(h1, w2, stride, 1), m2, b2)
        del h1
        y = conv_int8(h2, w3[None, None]).float().mul_(m3).add_(b3)
        if wd is None:
            iden = xc.float().mul_(sxr)
        else:
            iden = conv_int8(xc, wd[None, None], stride).float().mul_(
                md).add_(bd)
        outs.append(y.add_(iden).round_().clamp_(0, 127).to(
            torch.int8).contiguous())
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def fused_bottleneck_int8_plain(x, w1, m1, b1, w2, m2, b2, w3, m3, b3, sxr):
    return _block_plain(x, w1, m1, b1, w2, m2, b2, w3, m3, b3,
                        sxr=float(sxr))


def fused_bottleneck_down_int8_plain(x, w1, m1, b1, w2, m2, b2, w3, m3, b3,
                                     wd, md, bd, stride=1):
    return _block_plain(x, w1, m1, b1, w2, m2, b2, w3, m3, b3, stride=stride,
                        wd=wd, md=md, bd=bd)


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------


def _check_x(x, what):
    if x.device.type != 'cuda':
        raise ValueError(f'{what}: expected a CUDA tensor, got {x.device}')
    if x.dim() != 4 or x.dtype != torch.int8:
        raise ValueError(f'{what}: expected an (N, H, W, C) int8 tensor, got '
                         f'{tuple(x.shape)} {x.dtype}')
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f'{what}: activation must be contiguous and '
                         '16-byte aligned')
    if x.shape[-1] % 16:
        raise ValueError(f'{what}: channels must be a multiple of 16')


def _check_conv(w, m, b, k, cout, dev, what):
    if (w.dtype != torch.int8 or w.device != dev
            or tuple(w.shape) != (cout, k) or not w.is_contiguous()
            or w.data_ptr() % 16):
        raise ValueError(f'{what}: weight must be the contiguous K-major '
                         f'({cout}, {k}) int8 tensor of gemm_layout.kmajor '
                         f'on {dev}, got {tuple(w.shape)} {w.dtype} '
                         f'{w.device}')
    for t, name in ((m, 'multiplier'), (b, 'bias')):
        if (t.dtype != torch.float32 or t.device != dev
                or tuple(t.shape) != (cout,) or not t.is_contiguous()):
            raise ValueError(f'{what}: {name} must be a contiguous ({cout},) '
                             f'f32 tensor on {dev}')


def _gemm(out, segs, mode, res=None, sxr=0.0):
    """One launch of the implicit-GEMM kernel into `out` (N, Ho, Wo,
    Cout) int8. segs: [(x, w, m, b, stride, ksize)] with w the K-major
    (Cout, K) weights, one segment, or two in the projection mode."""
    N, Ho, Wo, Cout = out.shape
    dev = out.device
    bn = gemm_layout.tile_n(Cout, two_sums=mode == _PROJECTION)
    args = []
    for x, w, m, b, stride, ksize in segs:
        _check_x(x, 'int8 bottleneck')
        _check_conv(w, m, b, ksize * ksize * x.shape[-1], Cout, dev,
                    'int8 bottleneck')
        args += [x.data_ptr(), w.data_ptr(), m.data_ptr(), b.data_ptr(),
                 x.shape[-1], x.shape[1], x.shape[2], stride, ksize]
    if len(segs) == 1:
        args += [None, None, None, None, 16, 1, 1, 1, 1]
    if res is not None:
        _check_x(res, 'int8 bottleneck residual')
        if tuple(res.shape) != tuple(out.shape):
            raise ValueError('identity residual must match the output shape')
    rc = _build.launch(
        'io_conv_gemm_s8', dev, *args, N, Ho, Wo, Cout, bn,
        None if res is None else res.data_ptr(), float(sxr), out.data_ptr(),
        mode)
    _build.check(rc, 'int8 bottleneck gemm')
    return out


def _block_cuda(x, wk, m1, b1, m2, b2, m3, b3, stride=1, sxr=None, md=None,
                bd=None):
    """The three launches of one int8c bottleneck: conv1 and the 3x3 into
    int8 scratch, then conv3 with the identity residual or the
    projection's own accumulator. wk: the block's K-major weights [w1,
    w2, w3(, wd)] (gemm_layout.kmajor of each)."""
    _check_x(x, 'int8 bottleneck')
    if stride not in (1, 2):
        raise ValueError(f'stride must be 1 or 2, got {stride}')
    if wk is None or len(wk) != (3 if md is None else 4):
        raise ValueError('int8 bottleneck: the card takes the K-major '
                         'weights (wk=, gemm_layout.kmajor of each), laid '
                         'out once when the model is built on the card')
    N, H, W, _ = x.shape
    Cm, Cout = wk[0].shape[0], wk[2].shape[0]
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    dev = x.device
    h1 = _gemm(torch.empty((N, H, W, Cm), dtype=torch.int8, device=dev),
               [(x, wk[0], m1, b1, 1, 1)], _RQ8)
    h2 = _gemm(torch.empty((N, Ho, Wo, Cm), dtype=torch.int8, device=dev),
               [(h1, wk[1], m2, b2, stride, 3)], _RQ8)
    out = torch.empty((N, Ho, Wo, Cout), dtype=torch.int8, device=dev)
    if md is not None:
        return _gemm(out, [(h2, wk[2], m3, b3, 1, 1),
                           (x, wk[3], md, bd, stride, 1)], _PROJECTION)
    return _gemm(out, [(h2, wk[2], m3, b3, 1, 1)], _RESIDUAL, res=x,
                 sxr=float(sxr))



# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _identity(wrapper, x, args, wk):
    if x.device.type == 'cpu':
        return fused_bottleneck_int8_plain(x, *args)
    _w1, m1, b1, _w2, m2, b2, _w3, m3, b3, sxr = args
    out = _block_cuda(x, wk, m1, b1, m2, b2, m3, b3, sxr=sxr)
    wrapper.launches += 1
    return out


def _projection(wrapper, x, args, stride, wk):
    if x.device.type == 'cpu':
        return fused_bottleneck_down_int8_plain(x, *args, stride=stride)
    _w1, m1, b1, _w2, m2, b2, _w3, m3, b3, _wd, md, bd = args
    out = _block_cuda(x, wk, m1, b1, m2, b2, m3, b3, stride=stride, md=md,
                      bd=bd)
    wrapper.launches += 1
    return out


def fused_bottleneck_int8(x, w1, m1, b1, w2, m2, b2, w3, m3, b3, sxr,
                          wk=None):
    """Stride-1 identity bottleneck. x (N, H, W, C) int8; w1 (C, Cm), w2
    (3, 3, Cm, Cm) HWIO, w3 (Cm, C) int8; m*, b* (Cout,) f32; sxr float;
    wk: the K-major [w1, w2, w3], which a CUDA x needs. -> (N, H, W, C)
    int8."""
    return _identity(fused_bottleneck_int8, x,
                     (w1, m1, b1, w2, m2, b2, w3, m3, b3, sxr), wk)


def fused_bottleneck_down_int8(x, w1, m1, b1, w2, m2, b2, w3, m3, b3, wd, md,
                               bd, stride=1, wk=None):
    """Projection bottleneck at stride 1 or 2. x (N, H, W, Cin) int8; w3
    (Cm, Cout); wd (Cin, Cout) int8; md, bd (Cout,) f32; wk: the
    K-major [w1, w2, w3, wd], which a CUDA x needs -> (N,
    ceil(H/s), ceil(W/s), Cout) int8."""
    return _projection(fused_bottleneck_down_int8, x,
                       (w1, m1, b1, w2, m2, b2, w3, m3, b3, wd, md, bd),
                       stride, wk)


def fused_bottleneck_int8_hwnc(x, w1, m1, b1, w2, m2, b2, w3, m3, b3, sxr,
                               wk=None):
    """The `hwnc` route's identity block: fused_bottleneck_int8 on NHWC."""
    return _identity(fused_bottleneck_int8_hwnc, x,
                     (w1, m1, b1, w2, m2, b2, w3, m3, b3, sxr), wk)


def fused_bottleneck_down_int8_hwnc(x, w1, m1, b1, w2, m2, b2, w3, m3, b3,
                                    wd, md, bd, wk=None):
    """The `hwnc` route's stride-1 projection on NHWC."""
    return _projection(fused_bottleneck_down_int8_hwnc, x,
                       (w1, m1, b1, w2, m2, b2, w3, m3, b3, wd, md, bd), 1,
                       wk)


def fused_bottleneck_down_s2_int8_hwnc(x, w1, m1, b1, w2, m2, b2, w3, m3,
                                       b3, wd, md, bd, wk=None):
    """The `hwnc` route's stride-2 projection on NHWC."""
    return _projection(fused_bottleneck_down_s2_int8_hwnc, x,
                       (w1, m1, b1, w2, m2, b2, w3, m3, b3, wd, md, bd), 2,
                       wk)


for _w in (fused_bottleneck_int8, fused_bottleneck_down_int8,
           fused_bottleneck_int8_hwnc, fused_bottleneck_down_int8_hwnc,
           fused_bottleneck_down_s2_int8_hwnc):
    _w.launches = 0
del _w
