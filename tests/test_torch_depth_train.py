"""InstaDepthNet training in the port against the JAX package's on the
CPU: the disparity losses, `binary_erosion`, `midas.apply_train` and the
InstaDepthNet_d / _od loss, gradients and new statistics.

The nets are the MiDaS family at trunk_layers = branch_layers = (1, 1, 1,
1), features 8, 64x64 (as tests/test_load_pretrain.py), drawn by the
port's init from a seed and carried to JAX with convert.py; out_conv3's
bias is set so that the ReLU'd disparity is 0 on part of each image and
positive on the rest: the runs of exact zeros are where JAX's |x|'(0) =
+1 and torch.abs's 0 part ways (losses._abs keeps JAX's), and the
image's minimum is tied over them.

Bars:
  * `min_max_norm`, `edge_aware_smoothness`: value within 1e-6 relative
    of JAX's, the gradient within 1e-6 of its max |JAX|, or within twice
    JAX's own f32 distance from the same function in f64 where that is
    larger (the smoothness's gradient sums every pixel in its means:
    JAX's f32 gradient is up to 2.5e-6 of its max from f64, the port's
    1.1e-6), on disparities with all-zero runs and tied maxima and
    minima;
    `disparity_order_violations` equal on the same arrays; erosion equal
    to scipy's and JAX's on every pixel, borders included;
  * `midas.apply_train`: outputs within 1e-5 of max |JAX| and the new
    statistics within 1e-5 of each leaf's max |JAX| (the train-mode bars
    of tests/test_torch_train_core.py);
  * `make_insta_depth_net` (the _d and _od YAMLs' weights; the occlusion
    BCE, which neither YAML turns on, is the order nets' `_occ_bce`, held
    in tests/test_torch_train_step.py): the loss within 1e-5 relative of
    jax.value_and_grad's, each gradient leaf within 1e-4 of its max |JAX
    grad| (a leaf of zeros, the occlusion branch the _od YAML does not
    train, exactly 0), the new statistics within 1e-5, the logs within
    1e-5 relative; the bars of tests/test_torch_train_step.py, on the
    port's ReLU branch (JAX's jax.nn.relu follows the port's masks).
    The violation count is held exactly where no pixel lies within 1e-5
    of max |disparity| of the thresholds it is compared with (asserted).
  * one build_train_step step of _od: the occlusion branch, which its
    loss does not reach, moves by weight decay alone, as under JAX's
    zero gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage
import torch

from instaorder_tpu import losses as JL
from instaorder_tpu.models import midas as jmidas
from instaorder_tpu.ops import morphology as JM
from instaorder_tpu.train import algos as JA

from instaorder_tpu_torch import convert
from instaorder_tpu_torch import losses as TL
from instaorder_tpu_torch.core.nn import tree_leaves, tree_unflatten
from instaorder_tpu_torch.models import midas as tmidas
from instaorder_tpu_torch.models.registry import get_backbone
from instaorder_tpu_torch.ops import morphology as TM
from instaorder_tpu_torch.train import algos as TA

from test_torch_train_step import (  # noqa: F401 (a fixture)
    one_torch_thread, recorded_relu, relu_on, worst)

SMALL = (1, 1, 1, 1)
SIZE = 64
FEATURES = 8
# the YAMLs' weights (experiments/InstaOrder/InstaDepthNet_{d,od})
D_W = {'overlap_weight': 0.1, 'distinct_weight': 0.9, 'smooth_weight': 0.1,
       'dorder_weight': 1, 'occ_order_weight': 0}
OD_W = {'overlap_weight': 0, 'distinct_weight': 0, 'smooth_weight': 0.1,
        'dorder_weight': 1, 'occ_order_weight': 0}
# (case, algo, variant, hyper)
CASES = [('d', 'InstaDepthNet_d', 'instadepthnet_d', D_W),
         ('od', 'InstaDepthNet_od', 'instadepthnet_od', OD_W)]
VIOLATION_MARGIN = 1e-5


def tensor(x, grad=False):
    return torch.tensor(np.asarray(x), requires_grad=grad)


def zero_run_disp(seed, n=3, h=12, w=16):
    """(N, H, W) ReLU-like disparity: runs of exact zeros (whole rows and
    blocks), a tied maximum and equal neighbours."""
    rng = np.random.RandomState(seed)
    d = np.maximum(rng.randn(n, h, w), 0).astype(np.float32)
    d[:, 2:5, :] = 0                        # all-zero rows
    d[0, 6:9, 3:11] = 0
    d[1, :, :] = np.round(d[1] * 4) / 4     # many ties
    d[2, 0, 0] = d[2, 7, 9] = d[2].max() + 1.0   # a tied maximum
    return d


@pytest.mark.parametrize('seed', [0, 1])
def test_min_max_norm_and_smoothness_match_jax(seed):
    d = zero_run_disp(seed)
    rgb = np.random.RandomState(seed + 10).randn(3, 12, 16, 3).astype(
        np.float32)
    rgb[:, :, 5:9, :] = 0.25                # flat image columns
    for jf, tf in ((lambda x: jnp.sum(JL.min_max_norm(x) ** 2),
                    lambda x, r: torch.sum(TL.min_max_norm(x) ** 2)),
                   (lambda x: JL.edge_aware_smoothness(x, rgb),
                    TL.edge_aware_smoothness)):
        wv, wg = jax.value_and_grad(jf)(jnp.asarray(d))
        x = tensor(d, grad=True)
        v = tf(x, tensor(rgb))
        (g,) = torch.autograd.grad(v, x)
        x64 = torch.tensor(d, dtype=torch.float64, requires_grad=True)
        (g64,) = torch.autograd.grad(
            tf(x64, torch.tensor(rgb, dtype=torch.float64)), x64)
        assert abs(float(v) - float(wv)) <= 1e-6 * abs(float(wv))
        wg = np.asarray(wg)
        scale = np.abs(wg).max()
        # JAX's own f32 rounding of the gradient, against the same
        # function in f64 (up to 2.5e-6 of its max here)
        spread = np.abs(wg - g64.numpy()).max() / scale
        assert np.abs(g.numpy() - wg).max() <= max(1e-6, 2 * spread) * scale
    # the |x|'(0) convention: torch.abs would give these zero runs a zero
    # gradient, JAX (and the port) +1
    x = torch.zeros(4, requires_grad=True)
    (g,) = torch.autograd.grad(TL._abs(x).sum(), x)
    assert g.tolist() == [1.0] * 4 == np.asarray(
        jax.grad(lambda v: jnp.abs(v).sum())(jnp.zeros(4))).tolist()
    x = torch.tensor([-0.0], requires_grad=True)
    (g,) = torch.autograd.grad(TL._abs(x).sum(), x)
    assert float(g) == float(jax.grad(jnp.abs)(-0.0)) == 1.0


def test_disparity_order_violations_match_jax():
    rng = np.random.RandomState(3)
    n = 8
    d1 = zero_run_disp(4, n, 20, 24)
    d2 = zero_run_disp(5, n, 20, 24)
    m1 = rng.rand(n, 20, 24) > 0.4
    m2 = rng.rand(n, 20, 24) > 0.5
    m1[0] = False                           # an empty eroded mask
    order = np.array([0, 1, 2, 0, 1, -1, 0, 1], np.int32)
    distinct = np.array([1, 1, 1, 0, 1, 1, 1, 1], bool)
    want = float(JL.disparity_order_violations(d1, d2, m1, m2, order,
                                               distinct))
    got = TL.disparity_order_violations(
        tensor(d1, grad=True), tensor(d2), tensor(m1), tensor(m2),
        tensor(order), tensor(distinct))
    assert float(got) == want and want > 0
    assert got.dtype == torch.float32 and not got.requires_grad


@pytest.mark.parametrize('shape', [(1, 1), (1, 7), (6, 1), (9, 13),
                                   (3, 40, 33)])
def test_binary_erosion_matches_scipy_and_jax(shape):
    rng = np.random.RandomState(sum(shape))
    m = rng.rand(*shape) > 0.2
    m[..., 0, :] = True                     # full border rows / columns
    m[..., :, -1] = True
    got = TM.binary_erosion(torch.from_numpy(m)).numpy()
    assert got.dtype == bool
    np.testing.assert_array_equal(got, np.asarray(JM.binary_erosion(m)))
    planes = m.reshape((-1,) + m.shape[-2:])
    want = np.stack([scipy.ndimage.binary_erosion(p) for p in planes])
    np.testing.assert_array_equal(got.reshape(want.shape), want)


def depth_net(variant, seed=0):
    """Port (params, stats, cfg) of a trimmed MiDaS net from a seed, its
    out_conv3 bias set so that the disparity of make_batch(4, 1) is 0 on
    about half of its pixels (the median pre-ReLU value lifted to 0)."""
    p, s, cfg = tmidas.init(torch.Generator().manual_seed(seed),
                            features=FEATURES, variant=variant,
                            trunk_layers=SMALL, branch_layers=SMALL)
    with torch.no_grad():
        pre = tmidas.apply_disp(p, s, dict(cfg, non_negative=False),
                                tensor(make_batch(4, 1)['rgb']))
    p['out_conv3']['b'] -= pre.median()
    return p, s, cfg


def make_batch(n, seed):
    """Rectangle masks (apart on half of the pairs), random RGB and the
    label fields, from a seed."""
    rng = np.random.RandomState(seed)
    rgb = rng.randn(n, SIZE, SIZE, 3).astype(np.float32)
    m1 = np.zeros((n, SIZE, SIZE), np.float32)
    m2 = np.zeros((n, SIZE, SIZE), np.float32)
    for i in range(n):
        y, x = rng.randint(0, SIZE // 2, 2)
        m1[i, y:y + 20, x:x + 16] = 1
        y, x = rng.randint(0, SIZE // 2, 2)
        m2[i, y:y + 18, x:x + 22] = 1
    depth = rng.randint(0, 2, n).astype(np.int32)
    depth[-1] = 2
    return {'rgb': rgb, 'modal1': m1, 'modal2': m2,
            'occ_order': rng.randint(0, 2, (n, 2)).astype(np.float32),
            'depth_order': depth,
            'is_overlap': np.array([1, 0] * (n // 2), np.int32)}


@pytest.fixture(scope='module')
def nets():
    return {v: depth_net(v, i) for i, v in enumerate(
        ('midas', 'instadepthnet_d', 'instadepthnet_od'))}


@pytest.mark.parametrize('variant', ['midas', 'instadepthnet_d',
                                     'instadepthnet_od'])
def test_apply_train_matches_jax(nets, variant):
    p, s, cfg = nets[variant]
    b = make_batch(4, 2)
    args = [b['rgb']] + ([] if variant == 'midas' else
                         [b['modal1'], b['modal2']])
    masks = []
    with recorded_relu(masks):
        got, gs = tmidas.apply_train(p, s, cfg, *map(tensor, args))
    with relu_on(masks):
        want, ws = jmidas.apply(convert.to_numpy(p), convert.to_numpy(s),
                                cfg, *args, train=True)
    got = [got] if variant == 'midas' else [o for o in got if o is not None]
    want = [want] if variant == 'midas' else [o for o in want
                                              if o is not None]
    assert len(got) == len(want) == (1 if variant == 'midas' else
                                     2 if variant == 'instadepthnet_d' else 3)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g.detach().numpy() - w).max() <= 1e-5 * np.abs(w).max()
    assert list(gs) == list(ws)
    err, leaf = worst(convert.to_numpy(gs), ws, 'stats')
    assert err <= 1e-5, (leaf, err)


def port_value_and_grad(loss_fn, params, stats, batch, masks):
    """(loss, grads, new stats, logs, disparities) of the port's loss_fn,
    numpy; a leaf the loss does not reach gets zeros (as in
    train/step.py); the forward's ReLU masks are appended to `masks`."""
    leaves = [t.detach().clone().requires_grad_(True)
              for t in tree_leaves(params)]
    disps = []
    real = tmidas._disp_path

    def disp_path(*a, **k):
        out = real(*a, **k)
        disps.append(out[0].detach().numpy())
        return out
    tmidas._disp_path = disp_path
    try:
        with recorded_relu(masks):
            loss, (new_stats, logs) = loss_fn(
                tree_unflatten(params, leaves), stats,
                {k: tensor(v) for k, v in batch.items()}, True)
    finally:
        tmidas._disp_path = real
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(
        leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]
    return (float(loss.detach()),
            convert.to_numpy(tree_unflatten(params, grads)),
            convert.to_numpy(new_stats),
            {k: float(v) for k, v in logs.items()}, disps)


def jax_value_and_grad(algo, cfg, hyper, params, stats, batch, masks):
    loss_fn = JA.make_loss(algo, jmidas.apply, cfg, hyper)
    with relu_on(masks):
        (loss, (ns, logs)), g = jax.jit(jax.value_and_grad(
            lambda p: loss_fn(p, stats, batch, True), has_aux=True))(params)
    return (float(loss), jax.tree_util.tree_map(np.asarray, g),
            jax.tree_util.tree_map(np.asarray, ns),
            {k: float(v) for k, v in logs.items()})


def violation_margin(disps, batch):
    """The least distance, over max |disparity|, of a pixel of an eroded
    mask from the threshold the violation count compares it with (mask
    1's pixels against the max over mask 2, mask 2's against the min over
    mask 1; left out, as exact in both packages: a ReLU'd 0 against a
    threshold of 0, and a pixel of both masks that is the threshold
    itself)."""
    e1 = scipy.ndimage.binary_erosion
    out = np.inf
    for d in disps:
        scale = np.abs(d).max()
        for i in range(d.shape[0]):
            m1 = e1(batch['modal1'][i] > 0.5)
            m2 = e1(batch['modal2'][i] > 0.5)
            if not (m1.any() and m2.any()):
                continue
            both = m1 & m2
            for thr, m in ((d[i][m2].max(), m1), (d[i][m1].min(), m2)):
                v, own = d[i][m], both[m]
                gap = np.abs(v - thr)[~((v == 0) & (thr == 0)) &
                                      ~(own & (v == thr))]
                if gap.size:
                    out = min(out, float(gap.min()) / scale)
    return out


@pytest.mark.parametrize('case', CASES, ids=[c[0] for c in CASES])
def test_insta_depth_net_matches_jax(nets, case):
    _, algo, variant, hyper = case
    p, s, cfg = nets[variant]
    batch = make_batch(4, 1)
    masks = []
    gl, gg, gs, glogs, disps = port_value_and_grad(
        TA.make_loss(algo, get_backbone(algo), cfg, hyper), p, s, batch,
        masks)
    zero = np.mean([(d == 0).mean() for d in disps])
    assert 0.2 < zero < 0.8, zero           # the |x|'(0) case is exercised
    assert violation_margin(disps, batch) > VIOLATION_MARGIN
    wl, wg, ws, wlogs = jax_value_and_grad(
        algo, cfg, hyper, convert.to_numpy(p), convert.to_numpy(s), batch,
        masks)
    assert abs(gl - wl) <= 1e-5 * abs(wl), (gl, wl)
    assert sorted(glogs) == sorted(wlogs)
    for k in glogs:
        assert abs(glogs[k] - wlogs[k]) <= 1e-5 * abs(wlogs[k]), k
    assert glogs['loss_disp_order'] > 0
    err, leaf = worst(gg, wg, 'grads')
    assert err <= 1e-4, f'worst gradient leaf {leaf}: {err:.3e}'
    err, leaf = worst(gs, ws, 'stats')
    assert err <= 1e-5, f'worst stats leaf {leaf}: {err:.3e}'
    if hyper['occ_order_weight'] == 0 and variant == 'instadepthnet_od':
        # the occlusion branch is not in the loss: zero gradients, as JAX's
        assert not any(np.any(x) for x in jax.tree_util.tree_leaves(
            gg['oo'])) and not any(np.any(np.asarray(x)) for x in
                                   jax.tree_util.tree_leaves(wg['oo']))
