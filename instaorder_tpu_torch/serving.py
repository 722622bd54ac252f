"""The occlusion serving paths: pair prep -> ResNet-50 -> sigmoid /
threshold, the counterpart of the root bench.py megastep and its three
profiles (`PROFILES`, `resolve_profile`):

  images (S, H, W, 3) + masks (S, N, H, W) + bboxes (S, N, 4)
    -> pair_rois -> pair prep -> (S*P, 256, 256, 5) bf16 (f32 for the
       f32 model)
    -> parity:     apply_folded_siamese (bf16 folded ResNet-50)
       serving-d2: apply_folded_v2_siamese (boundary-int8 v2)
       serving-d1: apply_folded_v2, one direction per pair
       --dtype int8c (any profile): apply_folded_int8[_siamese], the
                   fully quantized int8 model
       --dtype f32 (any profile): apply_folded[_siamese] of the folded
                   f32 model (the kernels' f32 modes)
    -> logits -> i_over_j, j_over_i decisions (the swap average of both
       directions at directions=2)

Prep routes (`prep_rgb`, as the root bench's --prep-rgb): 'einsum' the
cv2-exact dense matmuls (ops/pairs.build_pair_batches_matmul) at the
`prep_precision` ('default' | 'high' | 'highest', the root bench's
--prep-precision) and stage-1 dtype (--prep-stage1), 'pallas' the RGB
kernel plus the exact mask matmuls, 'pallas5' the 5-channel kernel; the
kernel routes take passes = 1 at 'default', else 3.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.nn import tree_cast
from .device import resolve_device
from .eval.decode import decode_occ
from .models import quantize as Q
from .models import resnet
from .models.folding import (add_f32_block_weights, add_stem_kernel_weights,
                             apply_folded, apply_folded_siamese, fold_resnet)
from .ops.pairs import (PRECISIONS, build_pair_batches_fused,
                        build_pair_batches_matmul, pair_rois)

# the root bench.py profiles (its PROFILES): dtype 'bf16' is the folded
# bf16 model, 'int8' the boundary-int8 v2 model ('int8c', the fully
# quantized model, is chosen with an explicit dtype); prep_precision
# 'high' is the 3-pass (f32) prep, 'default' the 1-pass bf16 knob
PROFILES = {
    'parity': {'dtype': 'bf16', 'directions': 2, 'prep_rgb': 'einsum',
               'prep_precision': 'high'},
    'serving-d2': {'dtype': 'int8', 'directions': 2,
                   'prep_precision': 'high'},
    'serving-d1': {'dtype': 'int8', 'directions': 1,
                   'prep_precision': 'default'},
}


# model dtypes the port serves (the root bench's --dtype)
DTYPES = ('int8c', 'int8', 'bf16', 'f32')


def prep_precision_of(profile, prep_precision=None):
    """The prep precision of `profile`, an explicit value winning (the
    root bench's --prep-precision): 'default', 'high' or 'highest'."""
    if prep_precision is not None and prep_precision not in PRECISIONS:
        raise ValueError(f'prep_precision must be one of {PRECISIONS}, '
                         f'got {prep_precision!r}')
    return prep_precision or PROFILES[profile]['prep_precision']


def resolve_profile(profile, prep_rgb=None, dtype=None, directions=None,
                    prep_precision=None):
    """A profile's settings, an explicit prep_rgb, dtype, directions or
    prep_precision winning (as the root bench's resolve_profile):
    {'dtype', 'directions', 'prep_rgb', 'passes'}. prep_rgb defaults to
    'pallas5' where the profile does not pin it, as in the root bench;
    passes (the kernel preps' mode) is 1 at the prep precision
    'default', else 3 (root bench.py prep_all). The precision itself is
    `prep_precision_of`."""
    preset = PROFILES[profile]
    if dtype is not None and dtype not in DTYPES:
        raise ValueError(f'dtype must be one of {DTYPES}, got {dtype!r}')
    if directions is not None and directions not in (1, 2):
        raise ValueError(f'directions must be 1 or 2, got {directions!r}')
    precision = prep_precision_of(profile, prep_precision)
    return {'dtype': dtype or preset['dtype'],
            'directions': directions or preset['directions'],
            'prep_rgb': prep_rgb or preset.get('prep_rgb', 'pallas5'),
            'passes': 1 if precision == 'default' else 3}


def synthetic_scenes(S, H=480, W=640, N=10, seed=0):
    """COCO-val-like synthetic scenes, drawn exactly as the root
    bench.py draws them: (images (S, H, W, 3) f32 in [0, 255), masks
    (S, N, H, W) f32 {0,1}, bboxes (S, N, 4) f32 xywh) as numpy."""
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 255, (S, H, W, 3)).astype(np.float32)
    masks = np.zeros((S, N, H, W), np.float32)
    bboxes = np.zeros((S, N, 4), np.float32)
    for s in range(S):
        for k in range(N):
            y0, x0 = rng.randint(0, H - 100), rng.randint(0, W - 100)
            hh, ww = rng.randint(30, 100, 2)
            masks[s, k, y0:y0 + hh, x0:x0 + ww] = 1
            bboxes[s, k] = [x0, y0, ww, hh]
    return images, masks, bboxes


def upload_scenes(images, masks, bboxes, device=None):
    """numpy scenes -> tensors on the device in the dtypes the prep
    kernel reads (images f32, masks uint8, bboxes f32)."""
    dev = resolve_device(device)
    return (torch.as_tensor(images, dtype=torch.float32, device=dev),
            torch.as_tensor(masks, device=dev).to(torch.uint8),
            torch.as_tensor(bboxes, dtype=torch.float32, device=dev))


def prep_pairs(images, masks, bboxes, pair_idx, out_size=256, passes=1,
               prep_rgb='pallas5', prep_precision='high', stage1_dtype=None,
               dtype=torch.bfloat16):
    """(S*P, out, out, 5) pair batch in `dtype` (bf16, or f32 for the f32
    model, as the root bench's prep_all writes its --dtype) for every
    pair of every scene through the `prep_rgb` route: the kernels at
    `passes`, 'einsum' at `prep_precision` with its stage-1 intermediate
    in `stage1_dtype` (None: f32)."""
    rois = pair_rois(bboxes, pair_idx)
    if prep_rgb == 'einsum':
        return build_pair_batches_matmul(images, masks, pair_idx, rois,
                                         out_size=out_size, dtype=dtype,
                                         precision=prep_precision,
                                         stage1_dtype=stage1_dtype)
    if prep_rgb not in ('pallas', 'pallas5'):
        raise ValueError(f'unknown prep_rgb {prep_rgb!r}')
    return build_pair_batches_fused(images, masks, pair_idx, rois,
                                    out_size=out_size, passes=passes,
                                    fuse_masks=prep_rgb == 'pallas5',
                                    dtype=dtype)


def _init_folded(seed, dev, weight_init):
    gen = torch.Generator().manual_seed(seed)
    params, stats, cfg = resnet.init(
        gen, arch='resnet50', in_channels=5, num_classes=2,
        weight_init=weight_init, device=dev)
    return fold_resnet(params, stats, cfg), cfg


def _calibrated(seed, calib_x, device, weight_init):
    """The folded f32 network from `seed` and its activation scales,
    calibrated on the prepped batch `calib_x`."""
    dev = resolve_device(device)
    folded, cfg = _init_folded(seed, dev, weight_init)
    return folded, cfg, Q.calibrate_folded_resnet(
        folded, cfg, [calib_x.to(dev).float()])


def build_serving_model(seed, calib_x, device=None, weight_init='xavier'):
    """InstaOrderNet_o for serving: a 5-channel ResNet-50 with a 2-logit
    occlusion head initialised from `seed`, BN-folded, calibrated in f32
    on the prepped batch `calib_x` (N, H, W, 5), then v2-quantized with
    bf16 weights. Returns (qparams, cfg).

    weight_init='xavier' (gain 0.02) is the root bench.py's model; its
    signal shrinks ~1e-12 through the trunk, below the 1e-8 scale floor,
    so every logit quantizes to 0. 'kaiming_out' (the torchvision
    constructor default) keeps the activations alive, which a check of
    the logits needs. On the card its conv1 also gets the stem kernel's
    weights (add_stem_kernel_weights)."""
    folded, cfg, scales = _calibrated(seed, calib_x, device, weight_init)
    q = Q.quantize_folded_v2(folded, cfg, scales)
    if resolve_device(device).type == 'cuda':
        add_stem_kernel_weights(q['conv1'])
    return q, cfg


def build_int8c_model(seed, calib_x, device=None, weight_init='xavier'):
    """The fully quantized (int8c) model: the same network from `seed`,
    BN-folded, calibrated in f32 on `calib_x`, then quantized with int8
    weights and per-channel f32 requant scales (quantize_folded_resnet).
    On the card each block also gets the K-major weights its kernel reads
    (Q.add_kernel_weights). Returns (qparams, cfg)."""
    folded, cfg, scales = _calibrated(seed, calib_x, device, weight_init)
    q = Q.quantize_folded_resnet(folded, cfg, scales)
    if resolve_device(device).type == 'cuda':
        Q.add_kernel_weights(q)
    return q, cfg


def build_parity_model(seed, device=None, weight_init='xavier'):
    """The `parity` profile's model: the same network from `seed`,
    BN-folded, every leaf cast to bf16 (the fc head too, as the root
    bench's tree_cast; the forward widens it back to f32). On the card
    its conv1 also gets the stem kernel's weights
    (add_stem_kernel_weights). Returns (params, cfg)."""
    dev = resolve_device(device)
    folded, cfg = _init_folded(seed, dev, weight_init)
    params = tree_cast(folded, torch.bfloat16)
    if dev.type == 'cuda':
        add_stem_kernel_weights(params['conv1'])
    return params, cfg


def build_f32_model(seed, device=None, weight_init='xavier'):
    """The `--dtype f32` model: the same network from `seed`, BN-folded,
    left in f32 (the root bench casts nothing at f32). On the card its
    conv1 also gets the f32 stem kernel's weights
    (add_stem_kernel_weights) and every block the f32 block kernel's
    split K-major weights (add_f32_block_weights). Returns (params,
    cfg)."""
    dev = resolve_device(device)
    folded, cfg = _init_folded(seed, dev, weight_init)
    if dev.type == 'cuda':
        add_stem_kernel_weights(folded['conv1'])
        add_f32_block_weights(folded)
    return folded, cfg


def build_model(profile, seed, calib_x, device=None, weight_init='xavier',
                dtype=None):
    """The model of `profile`'s dtype, or of an explicit `dtype`:
    build_parity_model for 'bf16', build_f32_model for 'f32',
    build_serving_model (calibrated on `calib_x`) for 'int8',
    build_int8c_model for 'int8c'."""
    dtype = resolve_profile(profile, dtype=dtype)['dtype']
    if dtype in ('bf16', 'f32'):
        build = build_parity_model if dtype == 'bf16' else build_f32_model
        return build(seed, device=device, weight_init=weight_init)
    build = build_int8c_model if dtype == 'int8c' else build_serving_model
    return build(seed, calib_x, device=device, weight_init=weight_init)


def compute_dtype(q):
    """The dtype a model's forward computes in, which its pair batch is
    written in: bf16 for the int8c and v2 models (their prep is bf16, as
    the root bench's), the folded model's own dtype (bf16 or f32)."""
    if 'cfg_scales' in q or 's_feat' in q:
        return torch.bfloat16
    return q['conv1']['w'].dtype


@torch.no_grad()
def megastep(q, cfg, images, masks, bboxes, pair_idx, out_size=256,
             passes=1, directions=1, prep_rgb='pallas5', use_pallas=True,
             prep_precision='high', stage1_dtype=None):
    """One serving step over S scenes. `q` is an int8c model
    (build_int8c_model, told by its 'cfg_scales' key), a v2 model
    (build_serving_model) or a folded model, bf16 (build_parity_model)
    or f32 (build_f32_model), which computes in its own dtype
    (`compute_dtype`, also the pair batch's); use_pallas is the kernel
    feature set (models/folding for the folded model, models/quantize
    for v2 and int8c; False runs no kernel in the model, as the root
    bench's --no-pallas). prep_precision and stage1_dtype steer the
    einsum prep (`prep_pairs`).

    Returns (logits, i_over_j (S*P,) bool, j_over_i (S*P,) bool), logits
    (S*P, 2) f32 at directions=1 and the pair (out1, out2) at
    directions=2 (out2 is the mask-swapped direction)."""
    if directions not in (1, 2):
        raise ValueError(f'directions must be 1 or 2, got {directions}')
    cdt = compute_dtype(q)
    x = prep_pairs(images, masks, bboxes, pair_idx, out_size=out_size,
                   passes=passes, prep_rgb=prep_rgb,
                   prep_precision=prep_precision, stage1_dtype=stage1_dtype,
                   dtype=cdt)
    if 'cfg_scales' in q:
        fwd = Q.apply_folded_int8_siamese if directions == 2 \
            else Q.apply_folded_int8
        logits = fwd(q, cfg, x, use_pallas=use_pallas)
    elif 's_feat' in q:
        fwd = Q.apply_folded_v2_siamese if directions == 2 \
            else Q.apply_folded_v2
        logits = fwd(q, cfg, x, use_pallas=use_pallas)
    else:
        fwd = apply_folded_siamese if directions == 2 else apply_folded
        logits = fwd(q, cfg, x, dtype=cdt, use_pallas=use_pallas)
    i_over_j, j_over_i = decode_occ(*logits) if directions == 2 \
        else decode_occ(logits)
    return logits, i_over_j, j_over_i
