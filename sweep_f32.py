#!/usr/bin/env python3
"""The f32 block GEMM (csrc/bottleneck_f32.cu, 3xTF32 on wgmma) one
launch at a time at the f32 trunk's shapes (the parity f32 batch, 360
images): device ms at each tile width it can take (64 and 128 output
columns) beside the bytes and 3xTF32 bounds, and its error against an
f64 reference next to cuDNN's f32 convolution (TF32 off).

    python3 sweep_f32.py [--images 360] [--reps 20] [--stem]

--stem times the f32 stem instead (csrc/stem.cu `stem_f32_kernel`, 3xTF32
on wgmma, its pack included) at the parity f32 route's double-width stem:
images / 2 inputs of 256 x 256 x 5, Cout 128, f32 out and q8, beside the
bytes bound, the 3xTF32 bound at the real K = 245 and the design's floor
at its K (288: the kernel skips the zero k8 steps, not the zero taps
inside a step), and the pooled output's error against an f64 reference
next to cuDNN's f32 stem (TF32 off).

One line per shape: M, K, the bounds in ms (bytes at 3.35 TB/s, TF32
operations at 495 TFLOP/s, three products a MAC), the ms and share of
the larger bound at each width, and the error columns: max |err| / max
|ref|, the mean signed err / ref and the rms err / ref over outputs
above a tenth of max |ref| (a bias toward zero shows as a negative
mean). Needs a GPU; the H100 rates and the timer are chip_smoke.py's.
"""

from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

from chip_smoke import H100_BYTES_PER_S, H100_TF32_PER_S, cuda_ms
from instaorder_tpu_torch.device import resolve_device
from instaorder_tpu_torch.ops import bottleneck_kernels as BK
from instaorder_tpu_torch.ops import gemm_layout
from instaorder_tpu_torch.ops import stem_kernels as SK
from instaorder_tpu_torch.ops.gemm_layout import split_kmajor_f32

# name, input H (= W), Cin, Cout, ksize, stride, the K-packed second
# segment (Cin, stride) or None, identity residual
SHAPES = [
    ('layer1 conv1 256->64', 64, 256, 64, 1, 1, None, False),
    ('layer1 3x3 64', 64, 64, 64, 3, 1, None, False),
    ('layer1 conv3 64->256 +res', 64, 64, 256, 1, 1, None, True),
    ('layer1 proj [64|64]->256', 64, 64, 256, 1, 1, (64, 1), False),
    ('layer2 conv1 512->128', 32, 512, 128, 1, 1, None, False),
    ('layer2 3x3 128', 32, 128, 128, 3, 1, None, False),
    ('layer2 conv3 128->512 +res', 32, 128, 512, 1, 1, None, True),
    ('layer2 proj [128|256 s2]->512', 32, 128, 512, 1, 1, (256, 2),
     False),
    ('layer3 conv1 512->256', 32, 512, 256, 1, 1, None, False),
    ('layer3 3x3 s2 256', 32, 256, 256, 3, 2, None, False),
    ('layer3 proj [256|512 s2]->1024', 16, 256, 1024, 1, 1, (512, 2),
     False),
    ('layer4 3x3 512', 8, 512, 512, 3, 1, None, False),
]


def _conv(x, w, stride, ks):
    """NHWC x, HWIO w -> NHWC, pad 1 for a 3x3."""
    return F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                    stride=stride, padding=ks // 2).permute(0, 2, 3, 1)


def _errors(got, ref):
    sel = ref.abs() > 0.1 * ref.abs().max()
    d = got.double() - ref
    rel = d[sel] / ref[sel]
    return (float(d.abs().max() / ref.abs().max()), float(rel.mean()),
            float((rel ** 2).mean().sqrt()))


def _stem_ref(x, w, b):
    """conv 7x7/2 pad 3 + bias, relu, max-pool 3x3/2 pad 1, NHWC."""
    h = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), stride=2,
                 padding=3)
    h = torch.relu(h + b[:, None, None])
    return F.max_pool2d(h, 3, 2, 1).permute(0, 2, 3, 1)


def stem(n, reps, rnd):
    """One line: the f32 stem at n double-width 256^2 inputs."""
    torch.backends.cudnn.allow_tf32 = False
    c, cout = 5, 128
    x = rnd(n, 256, 256, c)
    w = rnd(7, 7, c, cout, scale=(49 * c) ** -0.5)
    b = rnd(cout, scale=0.1)
    wk = SK.stem_kernel_weights(w)
    conv_px = n * 128 * 128
    t_bytes = (x.numel() + n * 64 * 64 * cout) * 4 / H100_BYTES_PER_S * 1e3
    tf32 = lambda k: 3 * 2 * conv_px * k * cout / H100_TF32_PER_S * 1e3
    k_kernel = wk.shape[-1]
    line = (f'f32 stem {n} x 256^2 x {c} -> {cout}: bound bytes '
            f'{t_bytes:.3f} 3xTF32 K=245 {tf32(245):.3f} design floor '
            f'K={k_kernel} {tf32(k_kernel):.3f} |')
    for q8 in (False, True):
        t = cuda_ms(torch, lambda q8=q8: SK.fused_stem(x, w, b, q8=q8,
                                                       wk=wk), reps)
        line += (f' {"q8" if q8 else "f32"} {t:.3f} ms '
                 f'({100 * tf32(245) / t:.1f}% of the K=245 bound)')
    ref = _stem_ref(x.double(), w.double(), b.double())
    for what, g in (('kernel', SK.fused_stem(x, w, b, wk=wk)),
                    ('cudnn f32', _stem_ref(x, w, b))):
        mx, mean, rms = _errors(g, ref)
        line += f' | {what} max {mx:.2e} mean {mean:.2e} rms {rms:.2e}'
    print(line, flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--images', type=int, default=360)
    ap.add_argument('--reps', type=int, default=20)
    ap.add_argument('--stem', action='store_true')
    args = ap.parse_args(argv)
    dev = resolve_device()
    gen = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *s, scale=1.0: torch.randn(*s, generator=gen,
                                            device=dev) * scale
    n = args.images
    print(torch.cuda.get_device_name(0))
    if args.stem:
        stem(n // 2, args.reps, rnd)
        return
    for name, h, cin, cout, ks, st, proj, res in SHAPES:
        a0 = torch.relu(rnd(n, h, h, cin))
        w0 = rnd(ks, ks, cin, cout, scale=(ks * ks * cin) ** -0.5)
        if proj:
            cx, sx = proj
            x = torch.relu(rnd(n, h * sx, h * sx, cx))
            wx = rnd(cx, cout, scale=cx ** -0.5)
            segs = [(a0, split_kmajor_f32(w0), 1, 1),
                    (x, split_kmajor_f32(wx), sx, 1)]
            ho, k = h, cin + cx
            ref = (_conv(a0.double(), w0.double(), 1, 1)
                   + _conv(x.double(), wx[None, None].double(), sx, 1))
            cudnn = _conv(a0, w0, 1, 1) + _conv(x, wx[None, None], sx, 1)
            in_bytes = (a0.numel() + x.numel() // (sx * sx)) * 4
        else:
            segs = [(a0, split_kmajor_f32(w0), st, ks)]
            ho, k = (h - 1) // st + 1, ks * ks * cin
            ref = _conv(a0.double(), w0.double(), st, ks)
            cudnn = _conv(a0, w0, st, ks)
            in_bytes = a0.numel() * 4
        out = torch.empty((n, ho, ho, cout), device=dev)
        b = torch.zeros(cout, device=dev)
        r = torch.relu(rnd(n, ho, ho, cout)) if res else None
        mode = BK._RES_RELU_F32 if (res or proj) else BK._RELU_F32
        t_bytes = (in_bytes + out.numel() * 4 * (2 if res else 1)
                   ) / H100_BYTES_PER_S * 1e3
        t_ops = 3 * 2 * out.numel() * k / H100_TF32_PER_S * 1e3
        line = (f'{name:32s} M {n * ho * ho:8d} K {k:5d} bound bytes '
                f'{t_bytes:.3f} 3xTF32 {t_ops:.3f} |')
        chosen = gemm_layout.tile_n_f32(cout, k)
        for bn in (64, 128):
            if cout % bn:
                continue
            t = cuda_ms(torch, lambda bn=bn: BK._gemm_f32(
                out, segs, b, mode, res=r, r=1.0, bias2=b if proj else None,
                bn=bn), args.reps)
            mark = '*' if bn == chosen else ''
            line += (f' bn{bn}{mark} {t:.3f} ms '
                     f'({100 * max(t_bytes, t_ops) / t:.0f}%)')
        # the error without the residual: relu of the sum against relu of
        # the f64 and of cuDNN's f32 sums
        got = BK._gemm_f32(out, segs, b, BK._RES_RELU_F32 if proj
                           else BK._RELU_F32, bias2=b if proj else None)
        ref, cudnn = torch.relu(ref), torch.relu(cudnn)
        for what, g in (('kernel', got), ('cudnn f32', cudnn)):
            mx, mean, rms = _errors(g, ref)
            line += (f' | {what} max {mx:.2e} mean {mean:.2e} '
                     f'rms {rms:.2e}')
        print(line, flush=True)


if __name__ == '__main__':
    main()
