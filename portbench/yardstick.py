"""The benchmark's yardstick: the card's published peaks and the work of
a step, counted from the layer shapes (reference/macs.py), never from
how the program computes it.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense): 989 TFLOP/s
bf16, 495 TFLOP/s TF32, 67 TFLOP/s f32 outside the tensor cores, 3.35
TB/s HBM3. A configuration names the peak its work is held to
(`"peak"`): bf16 for the v2 model, TF32 for f32 work (no f32-accurate
method runs faster than TF32's tensor cores, so no share can pass
100%).
"""

from __future__ import annotations

from .reference.macs import resnet50_blocks, resnet50_macs

PEAK_FLOPS = {'bf16': 989e12, 'tf32': 495e12, 'f32': 67e12}
HBM_BYTES_PER_S = 3.35e12


def forward_flops(cfg):
    """FLOPs (2 x MACs) of one forward of one input of the config."""
    s = cfg['input_size']
    return 2.0 * resnet50_macs(cfg['in_channels'], s, s, cfg['num_classes'])


def trunk_bound_s(cfg, batch):
    """The least time the card could take for the 16 bottleneck blocks of
    one trunk call on `batch` inputs: the sum over blocks of max(2 MACs /
    peak, bytes / HBM bandwidth), each block's input and output counted
    once at the configuration's activation storage size and its weights
    once at the weight storage size."""
    s = cfg['input_size']
    peak = PEAK_FLOPS[cfg['peak']]
    act, wb = cfg['storage_bytes']['activation'], cfg['storage_bytes']['weight']
    total = 0.0
    for b in resnet50_blocks(cfg['in_channels'], s, s):
        if b['name'] == 'stem':
            continue
        flops = 2.0 * b['macs'] * batch
        nbytes = batch * (b['in'] + b['out']) * act + b['weights'] * wb
        total += max(flops / peak, nbytes / HBM_BYTES_PER_S)
    return total
