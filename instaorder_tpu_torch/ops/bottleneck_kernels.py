"""Kernels 2-4 and 6-9: the boundary-int8 ("v2") bottleneck
(csrc/bottleneck_v2.cu).

Each wrapper replaces one TPU kernel of instaorder_tpu/ops/pallas_blocks.py
and takes NHWC (N, H, W, C) activations (the GPU's channels-last layout;
the TPU-only (H, W, N, C) view does not carry over):

  fused_bottleneck_i8v2_identity  <- fused_bottleneck_i8v2_hwnc
      stride 1, identity residual r*x
  fused_bottleneck_i8v2_down_s2   <- fused_bottleneck_down_s2_i8v2_hwnc
      stride 2, 1x1/2 projection residual
  fused_bottleneck_i8v2_stage     <- fused_bottleneck_i8v2_hwnc_stage
      down=True: ResNet-50 layer1, the stride-1 projection block then
      the identity blocks; down=False (down=None here): an identity run
  fused_bottleneck_i8v2_hwncp_stage <- fused_bottleneck_i8v2_hwncp_stage
      the down=True stage's function (the TPU kernel lane-packs the
      identity 3x3s; the card's GEMM tiles Cm = 64 at full width)
  fused_bottleneck_down_i8v2_hwnc <- fused_bottleneck_down_i8v2_hwnc
      stride 1, projection residual (K-packed)
  fused_bottleneck_i8v2           <- fused_bottleneck_i8v2
      the identity block on NHWC
  fused_bottleneck_down_i8v2      <- fused_bottleneck_down_i8v2
      stride 1, projection residual; the TPU kernel sums conv3 and the
      projection as two dots, the card K-packs them (f32 sums in another
      order: within the one-LSB block bar)
The last four launch the kernels of the first three and count their own
launches.

Math contract (quantize.quantize_folded_v2; the Pallas kernel bodies):
  h1  = cdt(relu(x . w1 + b1))                    f32 accumulation
  h2  = cdt(relu(conv3x3_s(h1) . w2 + b2))        pad 1, stride s
  y   = h2 . w3 + b3 + r*x        (identity)
  y   = [h2 | x_s] . [[w3],[wd]] + b3 + bd        (projection, one sum)
  out = clip(rint(y), 0, 127) as int8, or as cdt holding the integers
x is int8, or cdt holding integers 0..127; weights cdt (bf16 or f32 on
the card: quantize_folded_v2's compute_dtype); biases f32; r an f32
scalar.

Bound on the H100: tensor-core operations (see csrc/bottleneck_v2.cu).
Design: each block is three launches of one implicit-GEMM kernel (bf16
wgmma, f32 accumulators, 128 x 128 or 128 x 64 output tiles by
`gemm_layout.tile_n`) with h1/h2 in bf16 scratch from `torch.empty`.
With f32 weights (the v2 model at compute_dtype=f32) the same three
launches run the kernel's f32 mode (csrc/bottleneck_f32.cu: 3xTF32 on
wgmma, bound at 495 / 3 TFLOP/s; an int8 x is exact in TF32 and takes
two products) with h1/h2 in f32 scratch and
the output int8 or f32. That mode reads the weights split and K-major,
`wk` = [w1, w2, w3(, wd)] through gemm_layout.split_kmajor_f32, made
once when the model is built on the card (models/folding
`add_f32_block_weights`); a CUDA call at f32 without them raises.
A (64, 64, 256) layer1 plane is 1 MB (int8) per image, far beyond one
SM's shared memory, so the stage function runs the block kernels once
per block with the int8 activation between blocks in device memory
(L2 is 50 MB); fusing across blocks is later work.

On CPU tensors each wrapper runs its `_plain` version (PyTorch, f32 sums
on operands already rounded to the compute dtype: the same contract;
`wk` is not read).
On CUDA tensors it launches the kernel or raises, and adds one to its
`launches` count per call.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build, gemm_layout

# epilogue modes of csrc/bottleneck_v2.cu
_RELU_BF16, _Q8_INT8, _Q8_BF16, _RES_RELU_BF16 = 0, 1, 2, 3
# and of its f32 mode, csrc/bottleneck_f32.cu: relu(acc + b), relu(acc +
# b (+ b2) (+ r * x)), and the v2 boundary clip(rint(acc + b (+ b2) (+ r
# * x)), 0, 127) as int8 or as f32
_RELU_F32, _RES_RELU_F32, _Q8_INT8_F32, _Q8_F32 = 0, 1, 2, 3
# what an A segment of the f32 mode holds: f32 (split into hi and lo) or
# int8 (exact in TF32, no lo)
_A_F32, _A_INT8 = 0, 1


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _conv3x3(h, w2, stride):
    return F.conv2d(h.permute(0, 3, 1, 2), w2.permute(3, 2, 0, 1),
                    stride=stride, padding=1).permute(0, 2, 3, 1)


def _block_plain(x, w1, b1, w2, b2, w3, b3, stride=1, r=None, wd=None,
                 bd=None, out_int8=True):
    cdt = w1.dtype
    xf = x.to(cdt).float()
    h1 = torch.relu(xf @ w1.float() + b1).to(cdt)
    h2 = torch.relu(_conv3x3(h1.float(), w2.float(), stride) + b2).to(cdt)
    if wd is not None:
        xs = xf[:, ::stride, ::stride]
        y = torch.cat([h2.float(), xs], dim=-1) @ torch.cat(
            [w3.float(), wd.float()]) + b3 + bd
    else:
        y = h2.float() @ w3.float() + b3 + x.float() * r
    q = torch.clamp(torch.round(y), 0.0, 127.0)
    return q.to(torch.int8 if out_int8 else cdt)


def fused_bottleneck_i8v2_identity_plain(x, w1, b1, w2, b2, w3, b3, r,
                                         out_int8=True):
    return _block_plain(x, w1, b1, w2, b2, w3, b3, r=float(r),
                        out_int8=out_int8)


def fused_bottleneck_i8v2_down_s2_plain(x, w1, b1, w2, b2, w3, b3, wd, bd,
                                        out_int8=True):
    return _block_plain(x, w1, b1, w2, b2, w3, b3, stride=2, wd=wd, bd=bd,
                        out_int8=out_int8)


def fused_bottleneck_down_i8v2_hwnc_plain(x, w1, b1, w2, b2, w3, b3, wd, bd,
                                          out_int8=True):
    return _block_plain(x, w1, b1, w2, b2, w3, b3, wd=wd, bd=bd,
                        out_int8=out_int8)


fused_bottleneck_i8v2_plain = fused_bottleneck_i8v2_identity_plain


def fused_bottleneck_down_i8v2_plain(x, w1, b1, w2, b2, w3, b3, wd, bd,
                                     out_int8=True):
    """Stride-1 projection with conv3 and the projection as two f32 dots,
    summed in the TPU kernel's order ((h2.w3 + b3) + x.wd) + bd."""
    cdt = w1.dtype
    xf = x.to(cdt).float()
    h1 = torch.relu(xf @ w1.float() + b1).to(cdt)
    h2 = torch.relu(_conv3x3(h1.float(), w2.float(), 1) + b2).to(cdt)
    y = h2.float() @ w3.float() + b3 + xf @ wd.float() + bd
    q = torch.clamp(torch.round(y), 0.0, 127.0)
    return q.to(torch.int8 if out_int8 else cdt)


def fused_bottleneck_i8v2_stage_plain(x, down, blocks, rs, out_int8=True):
    h = x
    if down is not None:
        h = _block_plain(x, *down[:6], wd=down[6], bd=down[7],
                         out_int8=out_int8 or bool(blocks))
    for k, (blk, r) in enumerate(zip(blocks, rs)):
        last = k == len(blocks) - 1
        h = _block_plain(h, *blk, r=float(r),
                         out_int8=out_int8 or not last)
    return h


fused_bottleneck_i8v2_hwncp_stage_plain = fused_bottleneck_i8v2_stage_plain


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------


def _check_act(x, what, dtypes=(torch.int8, torch.bfloat16)):
    if x.dim() != 4 or x.dtype not in dtypes:
        names = ' or '.join(str(d)[6:] for d in dtypes)
        raise ValueError(f'{what}: expected an (N, H, W, C) {names} '
                         f'tensor, got {tuple(x.shape)} {x.dtype}')
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f'{what}: activation must be contiguous and '
                         '16-byte aligned')
    if x.shape[-1] % 32:
        raise ValueError(f'{what}: channels must be a multiple of 32')


def _check_w(w, k, cout, dev, what):
    if (w.dtype != torch.bfloat16 or w.device != dev
            or tuple(w.shape) != (k, cout) or not w.is_contiguous()
            or w.data_ptr() % 16):
        raise ValueError(f'{what}: weight must be a contiguous ({k}, {cout}) '
                         f'bfloat16 tensor on {dev}, got '
                         f'{tuple(w.shape)} {w.dtype} {w.device}')


def _check_wk(w, k, cout, dev, what):
    if (w.dtype != torch.float32 or w.device != dev
            or tuple(w.shape) != (2, cout, k) or not w.is_contiguous()
            or w.data_ptr() % 16):
        raise ValueError(f'{what}: weight must be the contiguous (2, {cout}, '
                         f'{k}) f32 split K-major tensor on {dev} '
                         f'(gemm_layout.split_kmajor_f32), got '
                         f'{tuple(w.shape)} {w.dtype} {w.device}')


def _check_b(b, cout, dev, what):
    if (b.dtype != torch.float32 or b.device != dev
            or tuple(b.shape) != (cout,) or not b.is_contiguous()):
        raise ValueError(f'{what}: bias must be a contiguous ({cout},) f32 '
                         f'tensor on {dev}')


def _gemm(out, segs, bias, mode, bias2=None, res=None, r=0.0):
    """One launch of the implicit-GEMM kernel. segs: [(act, w, stride,
    ksize)] (one or two K segments); out (N, Ho, Wo, Cout). f32 weights
    or an f32 output run its f32 mode (`_gemm_f32`)."""
    if out.dtype == torch.float32 or any(
            w.dtype == torch.float32 for _a, w, _s, _k in segs):
        return _gemm_f32(out, segs, bias, mode, bias2=bias2, res=res, r=r)
    N, Ho, Wo, Cout = out.shape
    dev = out.device
    bn = gemm_layout.tile_n(Cout)
    gemm_layout.check_k_steps([ksize * ksize * act.shape[-1]
                               for act, _w, _s, ksize in segs])
    args = []
    for act, w, stride, ksize in segs + [(None, None, 1, 1)] * (2 - len(segs)):
        if act is None:
            args += [None, None, 0, 32, 1, 1, 1, 1]
            continue
        _check_act(act, 'bottleneck input')
        _check_w(w, ksize * ksize * act.shape[-1], Cout, dev, 'bottleneck')
        args += [act.data_ptr(), w.data_ptr(), int(act.dtype == torch.int8),
                 act.shape[-1], act.shape[1], act.shape[2], stride, ksize]
    _check_b(bias, Cout, dev, 'bottleneck')
    if bias2 is not None:
        _check_b(bias2, Cout, dev, 'bottleneck')
    if res is not None:
        _check_act(res, 'bottleneck residual')
        if tuple(res.shape) != tuple(out.shape):
            raise ValueError('identity residual must match the output shape')
    rc = _build.launch(
        'io_conv_gemm', dev, *args, N, Ho, Wo, Cout, bn, bias.data_ptr(),
        None if bias2 is None else bias2.data_ptr(),
        None if res is None else res.data_ptr(),
        int(res is not None and res.dtype == torch.int8), float(r),
        out.data_ptr(), mode)
    _build.check(rc, 'bottleneck gemm')
    return out


def _gemm_f32(out, segs, bias, mode, bias2=None, res=None, r=0.0,
              bn=None):
    """One launch of the implicit-GEMM kernel's f32 mode
    (csrc/bottleneck_f32.cu, 3xTF32): segs [(act, wk, stride, ksize)]
    with wk the segment's split K-major weights, (2, Cout, K)
    (gemm_layout.split_kmajor_f32); f32 biases; f32 or int8 activations
    and residual (int8 widened to f32 exactly); an f32 output, or an
    int8 one in the _Q8_INT8_F32 mode. An int8 segment takes two
    products, an f32 one three. A K step is F32_K_STEP elements of
    either type. bn: the tile width, gemm_layout.tile_n_f32's unless
    given (a timing sweep forces it)."""
    N, Ho, Wo, Cout = out.shape
    dev = out.device
    ks = [ksize * ksize * act.shape[-1] for act, _w, _s, ksize in segs]
    bn = gemm_layout.tile_n_f32(Cout, sum(ks)) if bn is None else bn
    gemm_layout.check_k_steps(ks, step=gemm_layout.F32_K_STEP)
    acts = (torch.int8, torch.float32)
    args = []
    for act, w, stride, ksize in segs + [(None, None, 1, 1)] * (2 - len(segs)):
        if act is None:
            args += [None, None, _A_F32, 32, 1, 1, 1, 1]
            continue
        _check_act(act, 'bottleneck input', acts)
        _check_wk(w, ksize * ksize * act.shape[-1], Cout, dev, 'bottleneck')
        kind = _A_INT8 if act.dtype == torch.int8 else _A_F32
        args += [act.data_ptr(), w.data_ptr(), kind, act.shape[-1],
                 act.shape[1], act.shape[2], stride, ksize]
    _check_b(bias, Cout, dev, 'bottleneck')
    if bias2 is not None:
        _check_b(bias2, Cout, dev, 'bottleneck')
    if res is not None:
        _check_act(res, 'bottleneck residual', acts)
        if tuple(res.shape) != tuple(out.shape):
            raise ValueError('identity residual must match the output shape')
    if not out.is_contiguous() or out.data_ptr() % 16:
        raise ValueError('bottleneck output must be contiguous and 16-byte '
                         'aligned')
    if out.dtype != (torch.int8 if mode == _Q8_INT8_F32 else torch.float32):
        raise ValueError(f'bottleneck output: {out.dtype} does not match '
                         f'the f32 epilogue mode {mode}')
    rc = _build.launch(
        'io_conv_gemm_f32', dev, *args, N, Ho, Wo, Cout, bn, bias.data_ptr(),
        None if bias2 is None else bias2.data_ptr(),
        None if res is None else res.data_ptr(),
        int(res is not None and res.dtype == torch.int8), float(r),
        out.data_ptr(), mode)
    _build.check(rc, 'bottleneck gemm (f32)')
    return out


def _block_gemms(x, w1, b1, w2, b2, w3, b3, out, mode, stride=1, r=None,
                 wd=None, bd=None, wk=None):
    """The three launches of one bottleneck into `out` (N, Ho, Wo, Cout):
    conv1 and the 3x3 into scratch, then conv3 with the epilogue `mode`
    and the identity residual r*x or the K-packed projection. f32
    weights run the kernel's f32 mode throughout (f32 scratch, `mode`
    one of the _*_F32 modes) on the block's split K-major weights `wk` =
    [w1, w2, w3(, wd)] (gemm_layout.split_kmajor_f32), which it needs;
    bf16 weights the bf16 one (bf16 scratch)."""
    if x.device.type != 'cuda':
        raise ValueError('bottleneck kernel: x must be a CUDA tensor')
    if x.dtype != torch.int8 and x.dtype != w1.dtype:
        raise ValueError(f'bottleneck kernel: {x.dtype} x needs weights of '
                         f'its dtype, got {w1.dtype}')
    N, H, W, _ = x.shape
    Cm = w1.shape[-1]
    Ho, Wo = out.shape[1], out.shape[2]
    dev = x.device
    f32 = w1.dtype == torch.float32
    sdt = torch.float32 if f32 else torch.bfloat16
    relu = _RELU_F32 if f32 else _RELU_BF16
    if f32:
        if wk is None or len(wk) != (3 if wd is None else 4):
            raise ValueError('f32 bottleneck kernel: the card takes the '
                             'split K-major weights (wk=, gemm_layout.'
                             'split_kmajor_f32 of w1, w2, w3 and wd), made '
                             'once when the model is built on the card')
        w1, w2, w3 = wk[:3]
        wd = None if wd is None else wk[3]
    else:
        w2 = w2.reshape(9 * Cm, Cm)
    h1 = _gemm(torch.empty((N, H, W, Cm), dtype=sdt, device=dev),
               [(x, w1, 1, 1)], b1, relu)
    h2 = _gemm(torch.empty((N, Ho, Wo, Cm), dtype=sdt, device=dev),
               [(h1, w2, stride, 3)], b2, relu)
    if wd is not None:
        return _gemm(out, [(h2, w3, 1, 1), (x, wd, stride, 1)], b3, mode,
                     bias2=bd)
    return _gemm(out, [(h2, w3, 1, 1)], b3, mode, res=x, r=float(r))


def _block_cuda(x, w1, b1, w2, b2, w3, b3, stride=1, r=None, wd=None,
                bd=None, out_int8=True, wk=None):
    """One v2 block on the card, in the weights' compute dtype (bf16, or
    f32: the kernel's f32 mode on the split weights `wk`); the output
    int8 or that dtype."""
    N, H, W, _ = x.shape
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    f32 = w1.dtype == torch.float32
    out = torch.empty((N, Ho, Wo, w3.shape[-1]),
                      dtype=torch.int8 if out_int8 else w1.dtype,
                      device=x.device)
    mode = ((_Q8_INT8_F32 if out_int8 else _Q8_F32) if f32
            else (_Q8_INT8 if out_int8 else _Q8_BF16))
    return _block_gemms(x, w1, b1, w2, b2, w3, b3, out, mode, stride=stride,
                        r=r, wd=wd, bd=bd, wk=wk)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def fused_bottleneck_i8v2_identity(x, w1, b1, w2, b2, w3, b3, r,
                                   out_int8=True, wk=None):
    """Stride-1 identity bottleneck. x (N, H, W, C); w1 (C, Cm); w2
    (3, 3, Cm, Cm); w3 (Cm, C); r float; wk: the split K-major [w1, w2,
    w3], which a CUDA call at f32 needs. -> (N, H, W, C) int8 or cdt."""
    if x.device.type == 'cpu':
        return fused_bottleneck_i8v2_identity_plain(
            x, w1, b1, w2, b2, w3, b3, r, out_int8=out_int8)
    out = _block_cuda(x, w1, b1, w2, b2, w3, b3, r=r, out_int8=out_int8,
                      wk=wk)
    fused_bottleneck_i8v2_identity.launches += 1
    return out


def fused_bottleneck_i8v2_down_s2(x, w1, b1, w2, b2, w3, b3, wd, bd,
                                  out_int8=True, wk=None):
    """Stride-2 projection bottleneck. x (N, H, W, Cin); wd (Cin, Cout);
    wk: the split K-major [w1, w2, w3, wd], which a CUDA call at f32
    needs -> (N, H/2, W/2, Cout) int8 or cdt."""
    if x.device.type == 'cpu':
        return fused_bottleneck_i8v2_down_s2_plain(
            x, w1, b1, w2, b2, w3, b3, wd, bd, out_int8=out_int8)
    out = _block_cuda(x, w1, b1, w2, b2, w3, b3, stride=2, wd=wd, bd=bd,
                      out_int8=out_int8, wk=wk)
    fused_bottleneck_i8v2_down_s2.launches += 1
    return out


def _stage_cuda(x, down, blocks, rs, out_int8, wk):
    if len(blocks) != len(rs):
        raise ValueError('one residual scale per identity block')
    if down is None and not blocks:
        raise ValueError('a stage needs at least one block')
    wk = [None] * (len(blocks) + (down is not None)) if wk is None else wk
    h = x
    if down is not None:
        h = _block_cuda(x, *down[:6], wd=down[6], bd=down[7],
                        out_int8=out_int8 or bool(blocks), wk=wk[0])
        wk = wk[1:]
    for k, (blk, r) in enumerate(zip(blocks, rs)):
        last = k == len(blocks) - 1
        h = _block_cuda(h, *blk, r=r, out_int8=out_int8 or not last,
                        wk=wk[k])
    return h


def fused_bottleneck_i8v2_stage(x, down, blocks, rs, out_int8=True,
                                wk=None):
    """A stage: the stride-1 projection block `down` = (w1, b1, w2, b2,
    w3, b3, wd, bd), or None for an identity run alone, then the
    identity blocks `blocks` = [(w1, b1, w2, b2, w3, b3)] with residual
    scales `rs`; wk: each block's split K-major weights (`down`'s
    first), which a CUDA call at f32 needs. The activation between
    blocks is int8 in device memory (exact: the values are integers
    0..127). x (N, H, W, Cin) -> (N, H, W, Cout)."""
    if x.device.type == 'cpu':
        return fused_bottleneck_i8v2_stage_plain(x, down, blocks, rs,
                                                 out_int8=out_int8)
    h = _stage_cuda(x, down, blocks, rs, out_int8, wk)
    fused_bottleneck_i8v2_stage.launches += 1
    return h


def fused_bottleneck_i8v2_hwncp_stage(x, down, blocks, rs, out_int8=True,
                                      wk=None):
    """fused_bottleneck_i8v2_stage's function with a projection block
    (ResNet-50 layer1: the `hwncp` feature)."""
    if down is None:
        raise ValueError('the hwncp stage starts with its projection block')
    if x.device.type == 'cpu':
        return fused_bottleneck_i8v2_hwncp_stage_plain(x, down, blocks, rs,
                                                       out_int8=out_int8)
    h = _stage_cuda(x, down, blocks, rs, out_int8, wk)
    fused_bottleneck_i8v2_hwncp_stage.launches += 1
    return h


def fused_bottleneck_down_i8v2_hwnc(x, w1, b1, w2, b2, w3, b3, wd, bd,
                                    out_int8=True, wk=None):
    """Stride-1 projection bottleneck, conv3 and the projection K-packed
    into one f32 sum. x (N, H, W, Cin); wd (Cin, Cout); wk as
    fused_bottleneck_i8v2_down_s2 takes it -> (N, H, W, Cout) int8 or
    cdt."""
    if x.device.type == 'cpu':
        return fused_bottleneck_down_i8v2_hwnc_plain(
            x, w1, b1, w2, b2, w3, b3, wd, bd, out_int8=out_int8)
    out = _block_cuda(x, w1, b1, w2, b2, w3, b3, wd=wd, bd=bd,
                      out_int8=out_int8, wk=wk)
    fused_bottleneck_down_i8v2_hwnc.launches += 1
    return out


def fused_bottleneck_i8v2(x, w1, b1, w2, b2, w3, b3, r, out_int8=True,
                          wk=None):
    """fused_bottleneck_i8v2_identity's function (the `identity`
    feature)."""
    if x.device.type == 'cpu':
        return fused_bottleneck_i8v2_plain(x, w1, b1, w2, b2, w3, b3, r,
                                           out_int8=out_int8)
    out = _block_cuda(x, w1, b1, w2, b2, w3, b3, r=r, out_int8=out_int8,
                      wk=wk)
    fused_bottleneck_i8v2.launches += 1
    return out


def fused_bottleneck_down_i8v2(x, w1, b1, w2, b2, w3, b3, wd, bd,
                               out_int8=True, wk=None):
    """Stride-1 projection bottleneck (the `down1` feature without an
    hwnc feature); on the card the K-packed launch of
    fused_bottleneck_down_i8v2_hwnc."""
    if x.device.type == 'cpu':
        return fused_bottleneck_down_i8v2_plain(
            x, w1, b1, w2, b2, w3, b3, wd, bd, out_int8=out_int8)
    out = _block_cuda(x, w1, b1, w2, b2, w3, b3, wd=wd, bd=bd,
                      out_int8=out_int8, wk=wk)
    fused_bottleneck_down_i8v2.launches += 1
    return out


fused_bottleneck_i8v2_identity.launches = 0
fused_bottleneck_i8v2_down_s2.launches = 0
fused_bottleneck_i8v2_stage.launches = 0
fused_bottleneck_i8v2_hwncp_stage.launches = 0
fused_bottleneck_down_i8v2_hwnc.launches = 0
fused_bottleneck_i8v2.launches = 0
fused_bottleneck_down_i8v2.launches = 0
