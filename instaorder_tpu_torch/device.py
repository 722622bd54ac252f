"""Device resolution for the port's entry points.

Entry points run on CUDA unless the caller explicitly asks for the CPU
(as the tests do). There is no silent fallback: asking for the default
device on a machine without a GPU raises.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """None/'cuda' -> the current CUDA device (raises without one);
    'cpu' -> the CPU. Also pins full-f32 matmuls and convolutions:
    cuDNN convs default to TF32, which would break the f32
    calibration forward's parity with the reference."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'instaorder_tpu_torch runs on CUDA by default and no GPU is '
            "available; pass device='cpu' to run the plain versions on "
            'the CPU')
    if dev.type not in ('cuda', 'cpu'):
        raise ValueError(f'unsupported device {dev}')
    return dev
