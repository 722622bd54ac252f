"""Weight bridge between the JAX package's parameter trees and the port's.

A JAX tree reaches this module as nested dicts/lists of numpy arrays
(`jax.device_get` output; bf16 leaves arrive as ml_dtypes bfloat16
arrays). `to_torch` turns it into the same tree of tensors on a chosen
device, `to_numpy` turns a port tree back. Layouts are unchanged on both
sides (NHWC/HWIO), so the bridge is a leaf-wise copy. It covers the
resnet `params`/`stats` trees, the folded tree and the v2 `qparams`
tree, whose scalar leaves (`r`, `s_feat`) become Python floats, and the
optimizer state (train/optim.py), whose integer scalar (Adam's step
count `t`, int32) stays a 0-d tensor of its dtype. A string leaf (the
legacy PConvUNet's `'sample': 'down-7'`, models/legacy.py) passes through
both ways unchanged.
"""

from __future__ import annotations

import numpy as np
import torch


def _leaf_to_torch(a, device):
    if isinstance(a, str):
        return a
    a = np.asarray(a)
    if a.ndim == 0 and not np.issubdtype(a.dtype, np.integer):
        return float(a)
    if a.dtype.name == 'bfloat16':
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device)


def to_torch(tree, device='cpu'):
    """numpy tree -> tensor tree on `device`; 0-d float leaves become
    Python floats, 0-d integer leaves 0-d tensors."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_torch(v, device) for v in tree]
    return _leaf_to_torch(tree, device)


def tree_to(tree, device):
    """Move every tensor leaf of a port tree to `device` (Python-float
    leaves stay as they are)."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def to_numpy(tree):
    """tensor tree -> numpy tree (bf16 leaves widen exactly to f32;
    Python floats become f32 scalars)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_numpy(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    if isinstance(tree, str):
        return tree
    return np.float32(tree)
