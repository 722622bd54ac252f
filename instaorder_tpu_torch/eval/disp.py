"""Dense disparity / depth evaluation, DIW ordinal and KITTI / NYU
(counterpart of instaorder_tpu/eval/disp.py).

Reference:
  DIW single-point WHDR      <- tools/test_disp_DIW.py:105-168
  KITTI/NYU dense metrics    <- tools/test_disp_KITTI.py:125-239
    (median disparity->depth scaling, depth clipped to [min, max])

The disparity forward (MidasNet, or an InstaDepthNet's disparity path)
runs on the card, one image a call; the ground-truth read-back and the
metrics stay on the host in numpy, as in the JAX package.

Not ported yet (raises NotImplementedError): the per-image debug PNGs of
`save_dir` (matplotlib, with `utils/visualize`, ROADMAP.md queue 1 item
4).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..compat.torch_convert import convert_checkpoint
from ..convert import to_numpy, to_torch, tree_to
from ..core import checkpoint as ckpt
from ..data.image_io import read_depth_png
from ..device import resolve_device
from ..models import midas
from ..ops.resize import resize_weights_linear
from .metrics import compute_errors

ALGO_VARIANTS = {'midas_pretrained': 'midas',
                 'InstaDepthNet_d': 'instadepthnet_d',
                 'InstaDepthNet_od': 'instadepthnet_od'}


def _host(x):
    """numpy of a forward's output (a tensor on any device, or numpy)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _upsample_half_pixel_np(disp, out_h, out_w):
    """torch bilinear align_corners=False resize of an (H, W) map."""
    Wy = resize_weights_linear(disp.shape[0], out_h)
    Wx = resize_weights_linear(disp.shape[1], out_w)
    return Wy @ disp @ Wx.T


def eval_diw(forward, reader, n_samples=-1, log=print):
    """DIW ordinal WHDR: the disparity of the 384^2 resize, upsampled
    bilinearly to the original image, compared at the two annotated
    pixels (a larger disparity is closer: 'disparity ordinal' is the
    reverse of 'depth ordinal', test_disp_DIW.py:137-147).

    forward: (1, 384, 384, 3) normalised NHWC (numpy) -> (1, h, w)
    disparity (a tensor or numpy). Returns {'whdr': %, 'n': count}."""
    n = len(reader) if n_samples == -1 else min(len(reader), n_samples)
    errors = []
    for i in range(n):
        img_orig, image_chw, (a_yx, b_yx, ordinal), fn = reader[i]
        disp = _host(forward(image_chw.transpose(1, 2, 0)[None]))[0]
        disp = _upsample_half_pixel_np(disp, img_orig.shape[0],
                                       img_orig.shape[1])
        da = disp[a_yx[0], a_yx[1]]
        db = disp[b_yx[0], b_yx[1]]
        pred = '<' if da > db else ('>' if da < db else '=')
        errors.append(int(pred != ordinal))
    whdr = float(np.sum(errors) / max(len(errors), 1) * 100)
    log(f'computed error on {len(errors)}')
    log(f'wrong/all = {int(np.sum(errors))}/{len(errors)}')
    log(f'WHDR = {whdr}')
    return {'whdr': whdr, 'n': len(errors)}


def eval_dense_depth(forward, reader, dataset='kitti', n_samples=-1,
                     read_gt_depth=None, log=print,
                     save_dir=None) -> Dict[str, float]:
    """KITTI / NYU: disparity -> (disp - min) / max (the reference's
    normalisation) -> depth = 1 / (norm + 1e-3) -> median scaling against
    the ground truth -> clip to [min_depth, max_depth] -> the 8 metrics
    (test_disp_KITTI.py:171-239).

    read_gt_depth(depth_name) -> float32 (H, W) depth in metres (0 =
    missing) or None; defaults to the KITTI uint16 / 256 PNG convention
    (image_io.read_depth_png). save_dir (the reference's per-image debug
    PNGs) is not ported yet."""
    if save_dir is not None:
        raise NotImplementedError(
            'eval_dense_depth save_dir: the debug PNGs need matplotlib and '
            'are not ported to instaorder_tpu_torch yet (ROADMAP.md queue '
            '1 item 4)')
    min_depth, max_depth = (1e-3, 80.0) if dataset == 'kitti' else (1e-3,
                                                                    10.0)
    if read_gt_depth is None:
        read_gt_depth = read_depth_png
    n = len(reader) if n_samples == -1 else min(len(reader), n_samples)
    errors = []
    missing = 0
    for i in range(n):
        image_chw, img_name, depth_name = reader[i]
        gt_depth = read_gt_depth(depth_name)
        if gt_depth is None:
            missing += 1
            continue
        if dataset == 'kitti':
            top = int(gt_depth.shape[0] - 352)
            left = int((gt_depth.shape[1] - 1216) / 2)
            gt_depth = gt_depth[top:top + 352, left:left + 1216]
        disp = _host(forward(image_chw.transpose(1, 2, 0)[None]))[0]
        norm = (disp - disp.min()) / disp.max()
        pred_depth = 1.0 / (norm + 1e-3)
        valid = (gt_depth >= min_depth) & (gt_depth <= max_depth)
        if not valid.any():
            missing += 1
            continue
        ratio = np.median(gt_depth[valid]) / np.median(pred_depth[valid])
        pred_depth = np.clip(pred_depth * ratio, min_depth, max_depth)
        errors.append(compute_errors(gt_depth[valid], pred_depth[valid]))
    log(f'computed error on {len(errors)} / {missing} missing')
    if not errors:
        return {'n': 0}
    keys = errors[0].keys()
    out = {k: float(np.mean([e[k] for e in errors])) for k in keys}
    out['n'] = len(errors)
    header = ('{:>8} | ' * 8).format('abs_rel', 'sq_rel', 'rmse',
                                     'rmse_log', 'd1', 'd2', 'd3', 'silog')
    vals = ('{: 8.3f}  ' * 8).format(
        out['abs_rel'], out['sq_rel'], out['rmse'], out['rmse_log'],
        out['d1'], out['d2'], out['d3'], out['silog'])
    log('\n  ' + header)
    log(vals)
    return out


def make_disp_forward(algo, load_model=None, features=256, device=None):
    """The disparity forward of an evaluation run. algo:
    'midas_pretrained' | 'InstaDepthNet_d' | 'InstaDepthNet_od'; the net
    at full width from seed 0, then `load_model` when given: a torch
    `.pt` / `.pth.tar` / `.pth` state_dict through
    compat/torch_convert.convert_checkpoint (family 'midas'), else the
    port's own checkpoint (core/checkpoint.load_state). device: None is the card
    (device.resolve_device), 'cpu' the CPU. Returns forward(x): x an
    (N, H, W, 3) normalised NHWC array or tensor -> the (N, H, W)
    disparity, a tensor on the device (models/midas.apply_disp; an
    InstaDepthNet's order branches do not touch it)."""
    dev = resolve_device(device)
    params, stats, cfg = midas.init(torch.Generator().manual_seed(0),
                                    features=features,
                                    variant=ALGO_VARIANTS[algo])
    if load_model and load_model.endswith(('.pt', '.pth.tar', '.pth')):
        params, stats, _ = convert_checkpoint(load_model, cfg, 'midas')
    elif load_model:
        _, params, stats, _ = ckpt.load_state(load_model, to_numpy(params),
                                              to_numpy(stats))
        params, stats = to_torch(params), to_torch(stats)
    params, stats = tree_to(params, dev), tree_to(stats, dev)

    def forward(x):
        x = torch.as_tensor(x, dtype=torch.float32, device=dev)
        with torch.no_grad():
            return midas.apply_disp(params, stats, cfg, x)
    return forward
