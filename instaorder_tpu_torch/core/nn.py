"""Functional NN layers on NHWC tensors with HWIO weights.

Counterpart of instaorder_tpu/core/nn.py: parameters are plain nested
dicts of tensors and every layer is a function `y = f(params, x)`.
Activations stay NHWC and conv weights HWIO at this boundary (so the
tests compare like with like); `conv2d` permutes to PyTorch's NCHW/OIHW
views only around the `F.conv2d` call.

Initialisers draw from an explicit `torch.Generator`. They reproduce the
reference formulas (torch / JAX parity), not the JAX random bits: tests
move JAX-initialised trees across with `convert.py` instead.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _fans(shape):
    """fan_in / fan_out for HWIO conv or (in, out) linear weights."""
    if len(shape) == 2:
        return shape[0], shape[1]
    kh, kw, cin_g, cout = shape
    return cin_g * kh * kw, cout * kh * kw


def xavier_normal(gen, shape, gain=1.0):
    fan_in, fan_out = _fans(shape)
    std = gain * math.sqrt(2.0 / (fan_in + fan_out))
    return std * torch.randn(shape, generator=gen)


def kaiming_normal_fan_out(gen, shape):
    """torch.nn.init.kaiming_normal_(mode='fan_out', nonlinearity='relu')."""
    _, fan_out = _fans(shape)
    std = math.sqrt(2.0 / fan_out)
    return std * torch.randn(shape, generator=gen)


def conv_init(gen, kh, kw, cin, cout, groups=1, init='kaiming_out',
              gain=0.02, bias=False):
    """{'w': HWIO weights[, 'b': zeros (cout,)]}."""
    shape = (kh, kw, cin // groups, cout)
    if init == 'kaiming_out':
        p = {'w': kaiming_normal_fan_out(gen, shape)}
    elif init == 'xavier':
        p = {'w': xavier_normal(gen, shape, gain)}
    else:
        raise ValueError(init)
    if bias:
        p['b'] = torch.zeros((cout,))
    return p


def linear_init(gen, cin, cout, init='torch_default', gain=0.02):
    if init == 'xavier':
        return {'w': xavier_normal(gen, (cin, cout), gain),
                'b': torch.zeros((cout,))}
    if init == 'torch_default':
        # nn.Linear default: kaiming_uniform(a=sqrt(5)) w + uniform bias
        bound = 1.0 / math.sqrt(cin)
        return {'w': torch.empty((cin, cout)).uniform_(-bound, bound,
                                                       generator=gen),
                'b': torch.empty((cout,)).uniform_(-bound, bound,
                                                   generator=gen)}
    raise ValueError(init)


def bn_init(c):
    params = {'scale': torch.ones((c,)), 'bias': torch.zeros((c,))}
    stats = {'mean': torch.zeros((c,)), 'var': torch.ones((c,))}
    return params, stats


def conv2d(params, x, stride=1, padding=0, groups=1, dilation=1):
    """NHWC conv with torch semantics (cross-correlation, zero pad). The
    bias, when present, is added after the conv in its own dtype, so a
    bf16 conv plus an f32 bias promotes to f32 as jax does."""
    out = F.conv2d(x.permute(0, 3, 1, 2), params['w'].permute(3, 2, 0, 1),
                   stride=stride, padding=padding, dilation=dilation,
                   groups=groups).permute(0, 2, 3, 1)
    if 'b' in params:
        out = out + params['b']
    return out


def batch_norm_eval(params, stats, x, eps=1e-5):
    """Eval-mode BatchNorm over the channel (last) axis, f32 math."""
    inv = torch.rsqrt(stats['var'].float() + eps) * params['scale'].float()
    out = (x.float() - stats['mean'].float()) * inv + params['bias'].float()
    return out.to(x.dtype)


def batch_norm(params, stats, x, train, momentum=0.1, eps=1e-5):
    """BatchNorm over (N, H, W) of NHWC input; returns (y, new_stats).

    train=True: normalise with the batch statistics (f32, biased
    variance) and return running statistics updated with the unbiased
    variance, n / max(n - 1, 1), as the JAX package's `batch_norm`.
    Functional: `stats` is never written; the new statistics are fresh
    f32 tensors outside the autograd graph, so a recomputed
    (checkpointed) forward or a second siamese pass cannot update them
    twice. The batch statistics come from `F.batch_norm` on fresh
    copies of the running ones (cuDNN's fused batch norm on the card,
    f32 statistics for a bf16 input, f64 ones for an f64 input); a
    single value per channel, which it refuses, takes the same formula
    written out. On the CPU its input is made a contiguous NCHW tensor
    first: PyTorch's CPU kernel for the channels-last view of an NHWC
    tensor normalises as x * a + b, which cancels where |mean| >> std
    (a mask net's first layers), while its contiguous kernel computes
    (x - mean) * a as the JAX package does.
    train=False: `batch_norm_eval`, stats returned as given."""
    if not train:
        return batch_norm_eval(params, stats, x, eps), stats
    n = x.numel() // x.shape[-1]
    ct = torch.promote_types(x.dtype, torch.float32)    # f64 stays f64
    mean = stats['mean'].detach().to(ct).clone()
    var = stats['var'].detach().to(ct).clone()
    scale, bias = params['scale'].to(ct), params['bias'].to(ct)
    if n > 1:
        xc = x.permute(0, 3, 1, 2)
        if x.device.type == 'cpu':
            xc = xc.contiguous()
        y = F.batch_norm(xc, mean, var, scale, bias, training=True,
                         momentum=momentum, eps=eps)
        return y.permute(0, 2, 3, 1), {'mean': mean, 'var': var}
    xf = x.to(ct)
    axes = tuple(range(x.ndim - 1))
    bm = xf.mean(axes)
    bv = xf.var(axes, unbiased=False)
    out = (xf - bm) * torch.rsqrt(bv + eps) * scale + bias
    return out.to(x.dtype), {
        'mean': (1 - momentum) * mean + momentum * bm.detach(),
        'var': (1 - momentum) * var + momentum * bv.detach()}


def max_pool(x, window=3, stride=2, padding=1):
    """torch nn.MaxPool2d parity on NHWC float input (-inf padding)."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride, padding)
    return y.permute(0, 2, 3, 1)


def avg_pool_global(x):
    """AdaptiveAvgPool2d((1,1)) + flatten: NHWC -> NC."""
    return x.mean(dim=(1, 2))


def linear(params, x):
    return x @ params['w'] + params['b']


def tree_cast(tree, dtype):
    """Every tensor leaf of a nested dict/list tree cast to `dtype`
    (Python-float leaves stay as they are)."""
    if isinstance(tree, dict):
        return {k: tree_cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_cast(v, dtype) for v in tree]
    return tree.to(dtype) if isinstance(tree, torch.Tensor) else tree


def tree_leaves(tree):
    """The leaves of a nested dict/list tree, dicts in their key order
    (`tree_map` visits them in the same order)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """fn over the leaves of `tree` and of the trees of the same structure
    in `rest` (dicts matched by key), in a new tree of that structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_unflatten(tree, leaves):
    """A tree of `tree`'s structure holding `leaves` in `tree_leaves`
    order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def param_count(tree) -> int:
    return sum(int(x.numel()) for x in tree_leaves(tree))
