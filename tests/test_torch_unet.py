"""The port's UNet family (models/unet.py, the PCNet-M backbone), its
registry entries and PCNet-M's loss against the JAX package's on the CPU.

The trees have the JAX init's structure (`jax.eval_shape`, so no JAX
init runs), filled from a numpy seed at scales that keep every layer's
activations O(1): a random init at xavier gain 0.02 under eval-mode
BatchNorm shrinks the output to ~1e-7, where a comparison says little.
The registry's own trees are held against JAX's shapes and config.

The f32 train-mode runs of the two packages stray a few 1e-6 of max
|logit| from an f64 run of the same function on these nets (JAX's up to
3.5e-6, the port's up to 4.2e-6): a dozen train-mode BatchNorms on mask
inputs, whose |mean| >> std in the first layers, amplify f32 rounding.
The port's CPU BatchNorm computes (x - mean) * a on a contiguous input,
as JAX does (`test_batch_norm_precision_on_masks`: its f32 forward no
further from f64 than 1.5x JAX's); the bars below are those that JAX's
own f32 rounding needs, and the gradients are also held exactly: the
port's forward in f64 on the same branch.

Bars:
  * the forward (depth 2, 3 and 4 at odd and even sizes, so that the
    pad-to-skip path runs, and a *res variant): eval and train logits
    within 1e-5 of max |JAX| (train: measured <= 3.5e-6, JAX's own
    distance from f64 up to 3.5e-6) and the new statistics within 1e-5
    of each leaf's max |JAX| (measured <= 2.4e-6);
  * `mask_weighted_cross_entropy` on the same logits within 1e-6
    relative of JAX's, its gradient w.r.t. the logits within 1e-6 of
    its max;
  * the PCNet-M loss, its gradients and new statistics on one branch of
    the ReLUs and one argmax of each 2x2 max-pool: the port's f32
    forward records them; JAX's forward and the port's f64 one follow
    them (`relu_on`, `pool_on`; chip_smoke.on_branch and a gather).
    The inputs are 0/1 masks, so the first block's outputs are
    piecewise constant and its pools see exact ties, where two
    implementations may send the gradient to different pixels. The
    port in f64 against JAX: loss within 5e-6 relative (both take the
    log-softmax of f32-rounded logits and sum the N*H*W pixel CEs in
    f32, in other orders), each gradient leaf within 1e-4 of its max
    |JAX grad| (JAX's own f32 rounding; measured <= 4.1e-5). The port
    in f32: loss within 5e-6, each gradient leaf within 1e-4 of its max
    (measured <= 4.3e-5: JAX's rounding, the port's f32 gradients lie
    within 1.2e-5 of its f64 ones), the new statistics within 1e-5
    (measured <= 2.9e-6). A conv bias that feeds a
    train-mode BatchNorm has gradient 0 and is held on the tree's max
    gradient. The eval loss within 1e-6 of JAX's.
"""

import contextlib
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from instaorder_tpu import losses as JL
from instaorder_tpu.models import registry as JREG
from instaorder_tpu.models import unet as JU
from instaorder_tpu.train import algos as JA

from instaorder_tpu_torch import convert
from instaorder_tpu_torch import losses as TL
from instaorder_tpu_torch.core.nn import (tree_cast, tree_leaves,
                                          tree_unflatten)
from instaorder_tpu_torch.models import registry as TREG
from instaorder_tpu_torch.models import unet as TU
from instaorder_tpu_torch.train import algos as TA

from test_torch_train_step import (  # noqa: F401 (a fixture)
    one_torch_thread, recorded_relu, relu_on, worst)

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke as CS  # noqa: E402

# (name, patch size, batch): every depth, odd sizes (the pool floors, the
# up path pads), a *res variant
NETS = [('unet1d2', 33, 3), ('unet1d3', 35, 2), ('unet05', 37, 2),
        ('unet025res', 40, 2)]
PCNET_HYPER = {'inmask_weight': 5.0}


def jax_structure(name):
    """(params, stats) of JAX's registry init as ShapeDtypeStructs, and
    its cfg, without running the init."""
    box = {}

    def f(key):
        p, s, box['cfg'] = JREG.get_backbone(name)['init'](
            key, in_channels=2, n_classes=2)
        return p, s
    p, s = jax.eval_shape(f, jax.random.PRNGKey(0))
    return p, s, box['cfg']


def seeded_tree(shapes, rng, parent=''):
    """A numpy tree of `shapes`' structure: conv weights at kaiming scale,
    biases and BatchNorm parameters and statistics near their init."""
    if isinstance(shapes, dict):
        return {k: seeded_tree(v, rng, k) for k, v in shapes.items()}
    if isinstance(shapes, (list, tuple)):
        return [seeded_tree(v, rng, parent) for v in shapes]
    shape = tuple(shapes.shape)
    if len(shape) == 4:                         # HWIO conv
        fan_in = shape[0] * shape[1] * shape[2]
        return (rng.randn(*shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)
    if parent == 'var':
        return rng.uniform(0.5, 1.5, shape).astype(np.float32)
    if parent == 'scale':
        return (1.0 + 0.1 * rng.randn(*shape)).astype(np.float32)
    return (0.1 * rng.randn(*shape)).astype(np.float32)


def seeded_net(name, seed):
    ps, ss, cfg = jax_structure(name)
    rng = np.random.RandomState(seed)
    return seeded_tree(ps, rng), seeded_tree(ss, rng), cfg


def mask_batch(n, size, seed, rgb=False):
    """PCNet-M's batch: rectangle masks (modal erased by the eraser, the
    un-erased target) from a seed."""
    rng = np.random.RandomState(seed)
    target = np.zeros((n, size, size), np.int32)
    eraser = np.zeros((n, size, size), np.float32)
    for i in range(n):
        y, x = rng.randint(0, size // 2, 2)
        target[i, y:y + size // 2, x:x + size // 2] = 1
        y, x = rng.randint(0, size // 2, 2)
        eraser[i, y:y + size // 3, x:x + size // 2] = 1
    modal = target.astype(np.float32) * (1 - eraser)
    out = {'modal': modal, 'eraser': eraser, 'target': target}
    if rgb:
        out['rgb'] = rng.randn(n, size, size, 3).astype(np.float32)
    return out


def jax_pool_select(x, idx):
    """JAX's 2x2 / 2 max-pool of NHWC x taking, in each window, the input
    at the port's argmax `idx` (torch's flat H*W indices, (N, C, Ho,
    Wo)): the gradient goes where the port's goes."""
    n, h, w, c = x.shape
    ho, wo = h // 2, w // 2
    idx = jnp.transpose(jnp.asarray(idx), (0, 2, 3, 1))
    ky = idx // w - 2 * jnp.arange(ho)[None, :, None, None]
    kx = idx % w - 2 * jnp.arange(wo)[None, None, :, None]
    win = x[:, :2 * ho, :2 * wo].reshape(n, ho, 2, wo, 2, c)
    top = jnp.where(kx == 0, win[:, :, 0, :, 0], win[:, :, 0, :, 1])
    bot = jnp.where(kx == 0, win[:, :, 1, :, 0], win[:, :, 1, :, 1])
    return jnp.where(ky == 0, top, bot)


@contextlib.contextmanager
def recorded_pool(indices, ties=None):
    """The port's unet._max_pool2 records its argmax indices (torch's
    flat H*W index of each window's first maximum) into `indices`, and
    into ties[0] the number of windows whose maximum is not unique."""
    real = TU._max_pool2

    def pool(x):
        y, idx = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2, 0,
                              return_indices=True)
        indices.append(idx.detach().cpu().numpy())
        if ties is not None:
            xc = x[:, :2 * y.shape[2], :2 * y.shape[3]].detach()
            hits = F.avg_pool2d((xc == F.interpolate(
                y.detach(), scale_factor=2).permute(0, 2, 3, 1)).float()
                .permute(0, 3, 1, 2), 2) * 4
            ties[0] += int((hits > 1).sum())
        return y.permute(0, 2, 3, 1)
    TU._max_pool2 = pool
    try:
        yield indices
    finally:
        TU._max_pool2 = real


@contextlib.contextmanager
def pool_on(indices):
    """JAX's unet._max_pool2, while a forward is traced, takes each
    window's input at the port's argmax (`indices`, in call order)."""
    real = JU._max_pool2
    it = iter(indices)
    JU._max_pool2 = lambda x: jax_pool_select(x, next(it))
    try:
        yield
    finally:
        JU._max_pool2 = real
    assert next(it, None) is None, 'JAX ran fewer pools than the port'


@pytest.mark.parametrize('name', TREG.UNET_NAMES)
def test_registry_trees_match_jax(name):
    """Each of the 16 names: the port's init tree has JAX's keys and
    shapes, its cfg JAX's; the registry entry is the UNet's."""
    ps, ss, cfg = jax_structure(name)
    bb = TREG.get_backbone(name)
    p, s, tcfg = bb['init'](torch.Generator().manual_seed(0),
                            in_channels=2, n_classes=2, device='cpu',
                            num_classes=7)    # ignored, as in JAX
    shapes = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda v: tuple(np.shape(v)), t)
    assert shapes(convert.to_numpy(p)) == shapes(ps)
    assert shapes(convert.to_numpy(s)) == shapes(ss)
    assert tcfg == cfg
    assert bb['apply'] is TU.apply and bb['apply_train'] is TU.apply_train
    # xavier(0.02) convolutions with zero biases, BatchNorm at identity
    w = p['up1']['conv1']['w'].numpy()
    std = 0.02 * np.sqrt(2.0 / (9 * (w.shape[2] + w.shape[3])))
    assert abs(w.std() / std - 1) < 0.1
    assert not p['up1']['conv1']['b'].any()
    assert torch.equal(s['inc']['bn1']['var'], torch.ones_like(
        s['inc']['bn1']['var']))


@pytest.fixture(scope='module')
def nets():
    return {name: seeded_net(name, i) for i, (name, _, _) in
            enumerate(NETS)}


@pytest.mark.parametrize('name,size,n', NETS, ids=[c[0] for c in NETS])
def test_forward_matches_jax(nets, name, size, n):
    params, stats, cfg = nets[name]
    rng = np.random.RandomState(size)
    x = (rng.rand(n, size, size, 2) > 0.5).astype(np.float32)
    rgb = rng.randn(n, size, size, 3).astype(np.float32) \
        if cfg['use_rgb_encoder'] else None
    jf = jax.jit(lambda p, s, x, r, train: JU.apply(
        p, s, cfg, x, rgb=r, train=train), static_argnums=4)
    tp, ts = convert.to_torch(params), convert.to_torch(stats)
    tr = None if rgb is None else torch.from_numpy(rgb)
    with torch.no_grad():
        got = TU.apply(tp, ts, cfg, torch.from_numpy(x), rgb=tr).numpy()
        got_t, got_s = TU.apply_train(tp, ts, cfg, torch.from_numpy(x),
                                      rgb=tr)
    want, _ = jf(params, stats, x, rgb, False)
    want_t, want_s = jf(params, stats, x, rgb, True)
    for g, w in ((got, want), (got_t.numpy(), want_t)):
        w = np.asarray(w)
        assert g.shape == w.shape == (n, size, size, 2)
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max()
    err, leaf = worst(convert.to_numpy(got_s), want_s, 'stats')
    assert err <= 1e-5, (leaf, err)


def test_batch_norm_precision_on_masks():
    """tools/bn_precision.py's case (unet05 at 37^2, the registry's init
    from seed 0, 0/1 rectangle masks, train mode): the port's f32 forward
    no further from its f64 one than 1.5x JAX's f32 forward, relative to
    max |logit| (measured: the port 2.06e-6, JAX 7.02e-6; with PyTorch's
    channels-last CPU BatchNorm the port was 8.34e-6)."""
    p, s, cfg = TREG.get_backbone('unet05')['init'](
        torch.Generator().manual_seed(0), in_channels=2, n_classes=2,
        device='cpu')
    rng = np.random.RandomState(5)
    x = np.zeros((3, 37, 37, 2), np.float32)
    for i in range(3):
        for c in range(2):
            y0, x0 = rng.randint(0, 18, 2)
            x[i, y0:y0 + 18, x0:x0 + 14, c] = 1
    with torch.no_grad():
        exact, _ = TU.apply_train(tree_cast(p, torch.float64),
                                  tree_cast(s, torch.float64), cfg,
                                  torch.from_numpy(x).double())
        port, _ = TU.apply_train(p, s, cfg, torch.from_numpy(x))
    jy, _ = JU.apply(convert.to_numpy(p), convert.to_numpy(s), cfg, x,
                     train=True)
    scale = float(exact.abs().max())
    err = lambda y: float((torch.as_tensor(np.array(y)).double() -  # noqa
                           exact).abs().max()) / scale
    assert err(port) <= 1.5 * err(jy), (err(port), err(jy))


def test_mask_weighted_cross_entropy_matches_jax():
    rng = np.random.RandomState(0)
    logits = rng.randn(3, 11, 13, 2).astype(np.float32) * 3
    target = rng.randint(0, 2, (3, 11, 13)).astype(np.int32)
    mask = (rng.rand(3, 11, 13) > 0.6).astype(np.float32)
    for kw in ({}, {'inmask_weight': 2.5, 'outmask_weight': 0.5}):
        want, wg = jax.value_and_grad(
            lambda z: JL.mask_weighted_cross_entropy(z, target, mask,
                                                     **kw))(logits)
        z = torch.from_numpy(logits).requires_grad_(True)
        got = TL.mask_weighted_cross_entropy(
            z, torch.from_numpy(target), torch.from_numpy(mask), **kw)
        (gg,) = torch.autograd.grad(got, z)
        assert abs(float(got.detach()) - float(want)) <= \
            1e-6 * abs(float(want))
        wg = np.asarray(wg)
        assert np.abs(gg.numpy() - wg).max() <= 1e-6 * np.abs(wg).max()


def grads_worst(got, want):
    """(worst error, leaf path) of a gradient tree against JAX's: each
    leaf's max |got - want| over its max |want|; a conv bias that feeds
    a train-mode BatchNorm has gradient 0 (the normalisation removes
    it), so its leaf is held on the whole tree's max |want| instead."""
    gmax = max(float(np.abs(np.asarray(w)).max())
               for w in jax.tree_util.tree_leaves(want))
    out = (0.0, '')
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree_util.tree_leaves(got)):
        keys = [getattr(k, 'key', None) for k in path]
        w, g = np.asarray(w, np.float64), np.asarray(g, np.float64)
        zero = keys[-1] == 'b' and keys[-2] in ('conv1', 'conv2',
                                                 'reduce_conv')
        scale = gmax if zero else float(np.abs(w).max())
        out = max(out, (float(np.abs(g - w).max()) / scale,
                        jax.tree_util.keystr(path)))
    return out


def port_loss_grads(loss_fn, params, stats, batch, dtype, masks, indices,
                    ties=None):
    """(loss, grads, new_stats, logs) of the port's loss_fn in `dtype`,
    numpy. masks / indices empty: the forward's ReLU branch and pool
    argmaxes are recorded into them; else followed."""
    cast = lambda t: t.to(dtype) if t.is_floating_point() else t  # noqa
    tp = [cast(t).requires_grad_(True)
          for t in tree_leaves(convert.to_torch(params))]
    ts = tree_cast(convert.to_torch(stats), dtype)
    tb = {k: cast(torch.from_numpy(v)) for k, v in batch.items()}
    if masks:
        real_relu, relu = CS.on_branch(
            torch, [torch.from_numpy(m) for m in masks], [0])
        it = iter(indices)

        def pool(x):
            idx = torch.from_numpy(next(it))
            n, c, ho, wo = idx.shape
            plane = x.permute(0, 3, 1, 2).reshape(n, c, -1)
            y = torch.gather(plane, 2, idx.reshape(n, c, -1))
            return y.reshape(n, c, ho, wo).permute(0, 2, 3, 1)
        branch = contextlib.ExitStack()
        branch.callback(setattr, torch, 'relu', real_relu)
        branch.callback(setattr, TU, '_max_pool2', TU._max_pool2)
        torch.relu, TU._max_pool2 = relu, pool
    else:
        branch = contextlib.ExitStack()
        branch.enter_context(recorded_relu(masks))
        branch.enter_context(recorded_pool(indices, ties))
    with branch:
        loss, (new_stats, logs) = loss_fn(tree_unflatten(
            convert.to_torch(params), tp), ts, tb)
    grads = torch.autograd.grad(loss, tp)
    return (float(loss.detach()),
            convert.to_numpy(tree_unflatten(params, grads)),
            convert.to_numpy(new_stats), logs)


@pytest.mark.parametrize('name', ['unet05', 'unet025res'])
def test_pcnet_loss_grads_on_one_branch(nets, name):
    """The PCNet-M loss, its gradients and new statistics on one ReLU
    branch and one pool argmax (module docstring)."""
    params, stats, cfg = nets[name]
    size = dict((c[0], c[1]) for c in NETS)[name]
    hyper = dict(PCNET_HYPER, use_rgb=cfg['use_rgb_encoder'])
    batch = mask_batch(3, size, 5, rgb=cfg['use_rgb_encoder'])
    loss_fn = TA.make_loss('PartialCompletionMask', TREG.get_backbone(name),
                           cfg, hyper)
    masks, indices, ties = [], [], [0]
    loss, grads, new_stats, logs = port_loss_grads(
        loss_fn, params, stats, batch, torch.float32, masks, indices, ties)
    assert ties[0] > 0          # the argmax matters: exact ties exist
    assert float(logs['loss']) == loss
    jloss_fn = JA.make_loss('PartialCompletionMask', JU.apply, cfg, hyper)
    with relu_on(masks), pool_on(indices):
        (wl, (ws, _)), wg = jax.jit(jax.value_and_grad(
            lambda p: jloss_fn(p, stats, batch, True), has_aux=True))(params)
    l64, g64, _, _ = port_loss_grads(loss_fn, params, stats, batch,
                                     torch.float64, masks, indices)
    for got_l, got_g in ((l64, g64), (loss, grads)):
        assert abs(got_l - float(wl)) <= 5e-6 * abs(float(wl))
        err, leaf = grads_worst(got_g, wg)
        assert err <= 1e-4, (leaf, err)
    err, leaf = worst(new_stats, ws, 'stats')
    assert err <= 1e-5, (leaf, err)
    # the eval loss (train=False): eval-mode BatchNorm, stats returned
    with torch.no_grad():
        el, (es, _) = loss_fn(convert.to_torch(params),
                              convert.to_torch(stats),
                              {k: torch.from_numpy(v)
                               for k, v in batch.items()}, False)
    wl, _ = jax.jit(lambda p: jloss_fn(p, stats, batch, False))(params)
    assert abs(float(el) - float(wl)) <= 1e-6 * abs(float(wl))
