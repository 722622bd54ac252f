"""Kernels 10-14: the bf16 ResNet bottleneck (csrc/bottleneck_v2.cu) and
its f32 mode (csrc/bottleneck_f32.cu).

Each wrapper replaces one TPU kernel of instaorder_tpu/ops/pallas_blocks.py
and takes NHWC (N, H, W, C) activations:

  fused_bottleneck       <- fused_bottleneck
      stride 1, identity residual x (the `identity` feature)
  fused_bottleneck_down  <- fused_bottleneck_down (stride 1 and 2 sites)
      1x1/s projection residual (the `down` / `down1` features)
  fused_bottleneck_stage <- fused_bottleneck_stage
      K identity blocks in order (the `stage` feature)
  fused_bottleneck_stage_stream <- fused_bottleneck_stage_stream
      the same function (the `sstage` feature)
  fused_bottleneck_hwnc  <- fused_bottleneck_hwnc
      fused_bottleneck's function (the `hwnc` feature)

The TPU devices that set the last three apart (VMEM-resident or streamed
weight stacks, the activation kept in VMEM across a stage, the (H, W, N,
C) view) do not carry over: the stage wrappers run the identity block's
launches once per block, with the activation (bf16 or f32) between
blocks in device memory, and the hwnc wrapper launches the NHWC block.
Each counts its own launches.

Math contract (the Pallas kernel bodies `_bottleneck_kernel`,
`_bottleneck_down_kernel`, `_bottleneck_down_s2_kernel`), cdt = x.dtype:
  h1  = cdt(relu(x . w1 + b1))                    f32 accumulation
  h2  = cdt(relu(conv3x3_s(h1) . w2 + b2))        pad 1, stride s
  out = cdt(relu(h2 . w3 + b3 + x))               (identity)
  out = cdt(relu(h2 . w3 + b3 + x_s . wd + bd))   (projection)
with the biases added in f32. The CUDA kernel K-packs the projection as
one f32 sum [h2 | x_s] . [[w3],[wd]], which changes only the order of
the f32 sums.

Bound on the H100: tensor-core operations (the block's MACs against one
read of x and one write of out). Design: the same three launches of the
implicit-GEMM kernel as the boundary-int8 blocks
(ops/bottleneck_kernels.py), with the epilogue mode that adds the bias
and the residual (or the second bias) in f32 and rounds relu(y) to bf16
once. The TPU kernel's space-to-depth parity planes for stride 2 do not
carry over: the GEMM's im2col view reads strided taps directly.

The f32 mode (the TPU kernels run in f32 when given f32 activations;
h1 and h2 stay f32, never rounded): the same three launches of the f32
implicit-GEMM kernel, 3xTF32 on the tensor cores (bound at 495 / 3
TFLOP/s; one TF32 product would miss the f32 bar), h1/h2 in f32
scratch, the epilogue's adds in the same order with no rounding. It
reads the block's weights split and K-major, `wk` = [w1, w2, w3(, wd)]
through gemm_layout.split_kmajor_f32, made once when the model is built
on the card (models/folding `add_f32_block_weights`); a CUDA call at
f32 without them raises.

On CPU tensors each wrapper runs its `_plain` version (PyTorch, f32 sums
on operands in the compute dtype; f32 or bf16; `wk` is not read). On
CUDA tensors it launches the kernel or raises, and adds one to its
`launches` count per call (a bf16 and an f32 launch alike). The card
takes bf16 activations and weights, or f32 ones, and f32 biases.
"""

from __future__ import annotations

import torch

from .bottleneck_kernels import (_RES_RELU_BF16, _RES_RELU_F32,
                                 _block_gemms, _conv3x3)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _plain(x, w1, b1, w2, b2, w3, b3, stride=1, wd=None, bd=None):
    cdt = x.dtype
    xf = x.float()
    h1 = torch.relu(xf @ w1.float() + b1.float()).to(cdt)
    h2 = torch.relu(_conv3x3(h1.float(), w2.float(), stride)
                    + b2.float()).to(cdt)
    out = h2.float() @ w3.float() + b3.float()
    if wd is None:
        out = out + xf
    else:
        out = out + xf[:, ::stride, ::stride] @ wd.float() + bd.float()
    return torch.relu(out).to(cdt)


def fused_bottleneck_plain(x, w1, b1, w2, b2, w3, b3):
    return _plain(x, w1, b1, w2, b2, w3, b3)


def fused_bottleneck_down_plain(x, w1, b1, w2, b2, w3, b3, wd, bd,
                                stride=1):
    return _plain(x, w1, b1, w2, b2, w3, b3, stride=stride, wd=wd, bd=bd)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _cuda_block(x, w1, b1, w2, b2, w3, b3, stride=1, wd=None, bd=None,
                wk=None):
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f'bottleneck kernel: x is {x.dtype}; the card '
                         'takes bf16 or f32 activations')
    N, H, W, _ = x.shape
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    out = torch.empty((N, Ho, Wo, w3.shape[-1]), dtype=x.dtype,
                      device=x.device)
    mode = _RES_RELU_F32 if x.dtype == torch.float32 else _RES_RELU_BF16
    return _block_gemms(x, w1, b1, w2, b2, w3, b3, out, mode,
                        stride=stride, r=1.0 if wd is None else None,
                        wd=wd, bd=bd, wk=wk)


def fused_bottleneck(x, w1, b1, w2, b2, w3, b3, wk=None):
    """Stride-1 identity bottleneck. x (N, H, W, C); w1 (C, Cm); w2
    (3, 3, Cm, Cm) HWIO; w3 (Cm, C); biases (Cm,) / (C,), f32 on the
    card; wk: the split K-major [w1, w2, w3], which a CUDA call at f32
    needs. -> (N, H, W, C) in x.dtype."""
    if x.device.type == 'cpu':
        return fused_bottleneck_plain(x, w1, b1, w2, b2, w3, b3)
    out = _cuda_block(x, w1, b1, w2, b2, w3, b3, wk=wk)
    fused_bottleneck.launches += 1
    return out


def fused_bottleneck_down(x, w1, b1, w2, b2, w3, b3, wd, bd, stride=1,
                          wk=None):
    """Projection bottleneck at stride 1 or 2. x (N, H, W, Cin); w3
    (Cm, Cout); wd (Cin, Cout); wk: the split K-major [w1, w2, w3, wd],
    which a CUDA call at f32 needs -> (N, ceil(H/s), ceil(W/s), Cout)
    in x.dtype."""
    if stride not in (1, 2):
        raise ValueError(f'stride must be 1 or 2, got {stride}')
    if x.device.type == 'cpu':
        return fused_bottleneck_down_plain(x, w1, b1, w2, b2, w3, b3, wd,
                                           bd, stride=stride)
    out = _cuda_block(x, w1, b1, w2, b2, w3, b3, stride=stride, wd=wd,
                      bd=bd, wk=wk)
    fused_bottleneck_down.launches += 1
    return out


def fused_bottleneck_stage_plain(x, blocks):
    for blk in blocks:
        x = _plain(x, *blk)
    return x


fused_bottleneck_stage_stream_plain = fused_bottleneck_stage_plain
fused_bottleneck_hwnc_plain = fused_bottleneck_plain


def _cuda_stage(x, blocks, wk):
    if not blocks:
        raise ValueError('a stage needs at least one block')
    for blk, bwk in zip(blocks, [None] * len(blocks) if wk is None else wk):
        x = _cuda_block(x, *blk, wk=bwk)
    return x


def fused_bottleneck_stage(x, blocks, wk=None):
    """K stride-1 identity bottlenecks in order. blocks: [(w1, b1, w2, b2,
    w3, b3)] as fused_bottleneck takes them; wk: each block's split
    K-major weights, which a CUDA call at f32 needs. x (N, H, W, C) ->
    the same shape in x.dtype, rounded to it between blocks."""
    if x.device.type == 'cpu':
        return fused_bottleneck_stage_plain(x, blocks)
    out = _cuda_stage(x, blocks, wk)
    fused_bottleneck_stage.launches += 1
    return out


def fused_bottleneck_stage_stream(x, blocks, wk=None):
    """fused_bottleneck_stage's function (the JAX kernel streams the
    per-block weights through VMEM; the card reads them per launch)."""
    if x.device.type == 'cpu':
        return fused_bottleneck_stage_stream_plain(x, blocks)
    out = _cuda_stage(x, blocks, wk)
    fused_bottleneck_stage_stream.launches += 1
    return out


def fused_bottleneck_hwnc(x, w1, b1, w2, b2, w3, b3, wk=None):
    """fused_bottleneck's function on NHWC (the JAX kernel takes the
    (H, W, N, C) view)."""
    if x.device.type == 'cpu':
        return fused_bottleneck_hwnc_plain(x, w1, b1, w2, b2, w3, b3)
    out = _cuda_block(x, w1, b1, w2, b2, w3, b3, wk=wk)
    fused_bottleneck_hwnc.launches += 1
    return out


fused_bottleneck.launches = 0
fused_bottleneck_down.launches = 0
fused_bottleneck_stage.launches = 0
fused_bottleneck_stage_stream.launches = 0
fused_bottleneck_hwnc.launches = 0
