"""Checkpoint conversion CLI (counterpart of
instaorder_tpu/compat/convert_cli.py): a released torch `.pth.tar` ->
the port's checkpoint format (core/checkpoint.save_state).

    python -m instaorder_tpu_torch.compat.convert_cli \
        --torch-ckpt InstaOrder_InstaOrderNet_o.pth.tar \
        --algo InstaOrderNet_o --out ckpt_iter_0.ckpt

Covers the 14 released checkpoints (reference README.md:53-67) and the
MiDaS `model-f6b98070.pt`. The family and the backbone's settings follow
from the algo name. Runs on the CPU.
"""

from __future__ import annotations

import argparse
import os

ALGO_SPECS = {
    # algo -> (family, backbone init kwargs)
    'OrderNet': ('resnet', {'in_channels': 5, 'num_classes': 3}),
    'OrderNet_ext': ('resnet', {'in_channels': 5, 'num_classes': 4}),
    'InstaOrderNet_o': ('resnet', {'in_channels': 5, 'num_classes': 2}),
    'InstaOrderNet_d': ('resnet', {'in_channels': 5, 'num_classes': 3}),
    'InstaOrderNet_od': ('resnet', {'in_channels': 5,
                                    'num_classes': [2, 3]}),
    'pcnet_m': ('unet', {'in_channels': 2, 'n_classes': 2, 'w': 2,
                         'depth': 4}),
    'InstaDepthNet_d': ('midas', {'variant': 'instadepthnet_d'}),
    'InstaDepthNet_od': ('midas', {'variant': 'instadepthnet_od'}),
    'midas_pretrained': ('midas', {'variant': 'midas'}),
}


def convert(torch_ckpt: str, algo: str, out: str):
    import torch
    from ..core import checkpoint as ckpt
    from .torch_convert import convert_checkpoint
    family, kw = ALGO_SPECS[algo]
    if family == 'resnet':
        from ..models import resnet as mod
        kw = dict(kw, arch='resnet50')
    elif family == 'unet':
        from ..models import unet as mod
    else:
        from ..models import midas as mod
    _, _, cfg = mod.init(torch.Generator().manual_seed(0), **kw)
    params, stats, step = convert_checkpoint(torch_ckpt, cfg, family)
    path = ckpt.save_state(os.path.dirname(out) or '.', step, params, stats)
    if os.path.abspath(path) != os.path.abspath(out):
        os.replace(path, out)
    print(f'converted {torch_ckpt} (step {step}) -> {out}')
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--torch-ckpt', required=True)
    ap.add_argument('--algo', required=True, choices=sorted(ALGO_SPECS))
    ap.add_argument('--out', required=True)
    args = ap.parse_args(argv)
    return convert(args.torch_ckpt, args.algo, args.out)


if __name__ == '__main__':
    main()
