"""The port's training primitives against the JAX package's on the CPU:
train-mode BatchNorm, `resnet.apply_train`, the losses and label swaps,
SGD and Adam, `step_lr`, the samplers, and the optimizer state carried
across with convert.py.

Bars: BatchNorm and apply_train outputs and new statistics within 1e-5
of max |JAX|; losses within 1e-6; SGD and Adam parameters and state
within 1e-6 of max |JAX| after 5 steps; step_lr and the samplers equal.
Also, with test_torch_train_step.py's helpers: compute_dtype bf16 (the
loss within 1e-2 relative of JAX's bf16 loss, the master params and the
statistics stay f32, and the loss falls over 10 steps on a learnable
batch, as JAX's test_bf16_mixed_precision_training), and the case that
shows why the gradients are held on one ReLU branch.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instaorder_tpu import losses as JL
from instaorder_tpu.cli.config import load_config
from instaorder_tpu.core import nn as jnn
from instaorder_tpu.core.schedule import step_lr as jstep_lr
from instaorder_tpu.data import sampler as JS
from instaorder_tpu.models import resnet as jresnet
from instaorder_tpu.train import algos as JA
from instaorder_tpu.train import optim as JO

from instaorder_tpu_torch import convert, losses as TL
from instaorder_tpu_torch.core import nn as tnn
from instaorder_tpu_torch.core.schedule import step_lr as tstep_lr
from instaorder_tpu_torch.data import sampler as TS
from instaorder_tpu_torch.models import resnet as tresnet
from instaorder_tpu_torch.train import algos as TA
from instaorder_tpu_torch.train import optim as TO
from instaorder_tpu_torch.train import step as TST

from test_torch_train_step import (  # noqa: F401 (a fixture)
    NET, SIZE, jax_net, jax_value_and_grad, leaves, make_batch,
    one_torch_thread, port_value_and_grad, to_port, worst)
import torch_threads  # noqa: F401 (the suite's torch thread cap)

REPO = Path(__file__).resolve().parent.parent
LAYERS = (1, 1, 1, 1)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, bar, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= bar, f'{what}: {err:.3e} of max |JAX| > {bar}'


def _close_trees(got, want, bar, what):
    # both flattened by JAX (dict keys sorted)
    wl = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, want))
    gl = jax.tree_util.tree_leaves(convert.to_numpy(got))
    assert len(gl) == len(wl), what
    for i, (g, w) in enumerate(zip(gl, wl)):
        _close(g, w, bar, f'{what} leaf {i}')


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
def test_batch_norm_train(dtype):
    rng = np.random.RandomState(0)
    c = 16
    x = (rng.randn(4, 6, 5, c) * 2 + 0.5).astype(np.float32)
    bp = {'scale': rng.rand(c).astype(np.float32) + 0.5,
          'bias': rng.randn(c).astype(np.float32)}
    bs = {'mean': rng.randn(c).astype(np.float32) * 0.1,
          'var': rng.rand(c).astype(np.float32) + 0.5}
    jx = jnp.asarray(x)
    tx = _t(x)
    if dtype == 'bf16':
        jx = jx.astype(jnp.bfloat16)
        tx = tx.to(torch.bfloat16)
    want, wstats = jnn.batch_norm(bp, bs, jx, train=True)
    got, gstats = tnn.batch_norm(convert.to_torch(bp), convert.to_torch(bs),
                                 tx, train=True)
    assert got.dtype == tx.dtype
    _close(got.float().numpy(), np.asarray(want, np.float32), 1e-5, 'y')
    for k in ('mean', 'var'):
        assert gstats[k].dtype == torch.float32
        _close(gstats[k].numpy(), wstats[k], 1e-5, k)
    # the inputs are not written
    np.testing.assert_array_equal(convert.to_torch(bs)['mean'].numpy(),
                                  bs['mean'])


def test_batch_norm_single_value_per_channel():
    """n = 1: the running variance takes the biased one (n / max(n-1, 1))."""
    rng = np.random.RandomState(1)
    x = rng.randn(1, 1, 1, 8).astype(np.float32)
    bp = {'scale': np.ones(8, np.float32), 'bias': np.zeros(8, np.float32)}
    bs = {'mean': np.zeros(8, np.float32), 'var': np.ones(8, np.float32)}
    want, ws = jnn.batch_norm(bp, bs, jnp.asarray(x), train=True)
    got, gs = tnn.batch_norm(convert.to_torch(bp), convert.to_torch(bs),
                             _t(x), train=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    for k in ('mean', 'var'):
        np.testing.assert_allclose(gs[k].numpy(), np.asarray(ws[k]),
                                   atol=1e-6)


@pytest.fixture(scope='module')
def nets():
    out = {}
    for i, classes in enumerate((2, [2, 3])):
        p, s, cfg = jresnet.init(jax.random.PRNGKey(i), arch='resnet50',
                                 in_channels=5, num_classes=classes,
                                 weight_init='kaiming_out',
                                 layers_override=LAYERS)
        p = jax.tree_util.tree_map(np.asarray, p)
        s = jax.tree_util.tree_map(np.asarray, s)
        out[str(classes)] = (p, s, cfg)
    return out


@pytest.mark.parametrize('classes', ['2', '[2, 3]'])
def test_apply_train(nets, classes):
    p, s, cfg = nets[classes]
    x = np.random.RandomState(2).randn(4, 64, 64, 5).astype(np.float32)
    want, wstats = jresnet.apply(p, s, cfg, jnp.asarray(x), train=True)
    got, gstats = tresnet.apply_train(convert.to_torch(p),
                                      convert.to_torch(s), cfg, _t(x))
    if cfg['dual_head']:
        assert isinstance(got, tuple) and len(got) == 2
        for g, w, h in zip(got, want, ('occ', 'depth')):
            _close(g.detach().numpy(), w, 1e-5, h)
    else:
        _close(got.detach().numpy(), want, 1e-5, 'logits')
    _close_trees(gstats, wstats, 1e-5, 'stats')
    # eval apply is unchanged by the train flag's plumbing
    got_eval = tresnet.apply(convert.to_torch(p), convert.to_torch(s), cfg,
                             _t(x))
    want_eval, _ = jresnet.apply(p, s, cfg, jnp.asarray(x))
    g0 = got_eval[0] if cfg['dual_head'] else got_eval
    w0 = want_eval[0] if cfg['dual_head'] else want_eval
    _close(g0.numpy(), w0, 1e-5, 'eval logits')


def _loss_inputs():
    rng = np.random.RandomState(3)
    logits = (rng.randn(8, 3) * 3).astype(np.float32)
    probs = (1 / (1 + np.exp(-logits[:, :2]))).astype(np.float32)
    probs[0, 0] = 0.0       # log clamps at -100
    probs[1, 1] = 1.0
    occ = rng.randint(0, 2, (8, 2)).astype(np.float32)
    labels = rng.randint(0, 3, 8).astype(np.int32)
    labels_m = labels.copy()
    labels_m[2] = -1
    mask = rng.rand(8) > 0.4
    return logits, probs, occ, labels, labels_m, mask


LOSSES = {
    'bce': lambda L, a: L.bce(a['probs'], a['occ']),
    'bce_with_logits': lambda L, a: L.bce_with_logits(a['logits2'],
                                                      a['occ']),
    'cross_entropy': lambda L, a: L.cross_entropy(a['logits'],
                                                  a['labels']),
    'cross_entropy_masked': lambda L, a: L.cross_entropy_masked(
        a['logits'], a['labels_m'], a['mask']),
    'cross_entropy_masked_empty': lambda L, a: L.cross_entropy_masked(
        a['logits'], a['labels_m'], a['mask'] & False),
    'swap_depth_labels': lambda L, a: L.swap_depth_labels(a['labels_m']),
    'swap_occ_columns': lambda L, a: L.swap_occ_columns(a['occ']),
    'swap_ordernet_labels': lambda L, a: L.swap_ordernet_labels(
        a['labels4']),
}


@pytest.mark.parametrize('name', sorted(LOSSES))
def test_losses(name):
    logits, probs, occ, labels, labels_m, mask = _loss_inputs()
    a = {'logits': logits, 'logits2': logits[:, :2], 'probs': probs,
         'occ': occ, 'labels': labels, 'labels_m': labels_m, 'mask': mask,
         'labels4': np.arange(8, dtype=np.int32) % 4}
    want = np.asarray(LOSSES[name](JL, {k: jnp.asarray(v)
                                        for k, v in a.items()}))
    got = LOSSES[name](TL, {k: _t(v) for k, v in a.items()}).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_loss_gradients():
    """The fused BCE's gradient is (sigmoid(o) - t) / N, as JAX's."""
    logits, _, occ, *_ = _loss_inputs()
    o = _t(logits[:, :2]).requires_grad_(True)
    TL.bce_with_logits(o, _t(occ)).backward()
    want = jax.grad(lambda x: JL.bce_with_logits(x, jnp.asarray(occ)))(
        jnp.asarray(logits[:, :2]))
    np.testing.assert_allclose(o.grad.numpy(), np.asarray(want), atol=1e-7)


def _tree(seed):
    rng = np.random.RandomState(seed)
    return {'conv': {'w': rng.randn(3, 3, 4, 8).astype(np.float32)},
            'layer1': [{'bn': {'scale': rng.rand(8).astype(np.float32)}},
                       {'fc': {'w': rng.randn(8, 2).astype(np.float32),
                               'b': rng.randn(2).astype(np.float32)}}]}


@pytest.mark.parametrize('opt', ['SGD', 'SGD_wd0', 'Adam', 'Adam_wd'])
def test_optimizers(opt):
    jopt, topt = {
        'SGD': (JO.SGD(0.9, 1e-4), TO.SGD(0.9, 1e-4)),
        'SGD_wd0': (JO.SGD(0.9, 0.0), TO.SGD(0.9, 0.0)),
        'Adam': (JO.Adam(), TO.Adam()),
        'Adam_wd': (JO.Adam(0.5, 0.99, 1e-8, 1e-3),
                    TO.Adam(0.5, 0.99, 1e-8, 1e-3)),
    }[opt]
    params = _tree(0)
    jp, js = params, jopt.init(params)
    tp, ts = convert.to_torch(params), topt.init(convert.to_torch(params))
    for step in range(5):
        grads = _tree(10 + step)
        lr = 0.1 / (step + 1)
        jp, js = jopt.update(grads, js, jp, lr)
        tp, ts = topt.update(convert.to_torch(grads), ts, tp, lr)
    _close_trees(tp, jp, 1e-6, f'{opt} params')
    _close_trees(ts, js, 1e-6, f'{opt} state')
    if opt.startswith('Adam'):
        assert ts['t'].dtype == torch.int32 and int(ts['t']) == 5


def test_opt_state_round_trip():
    """A JAX opt_state (Adam: t an int32 scalar) crosses with convert.py
    and comes back with the same leaves and dtypes."""
    params = _tree(0)
    for jopt in (JO.SGD(), JO.Adam()):
        js = jax.tree_util.tree_map(np.asarray, jopt.init(params))
        ts = convert.to_torch(js)
        if 't' in js:
            assert isinstance(ts['t'], torch.Tensor)
            assert ts['t'].dtype == torch.int32 and ts['t'].ndim == 0
        back = convert.to_numpy(ts)
        wl = jax.tree_util.tree_leaves(js)
        gl = jax.tree_util.tree_leaves(back)
        for g, w in zip(gl, wl):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


def test_make_optimizer():
    assert TO.make_optimizer('SGD', weight_decay=1e-4) == TO.SGD(0.9, 1e-4)
    assert TO.make_optimizer('Adam', beta1=0.5) == TO.Adam(b1=0.5)
    with pytest.raises(ValueError):
        TO.make_optimizer('RMSprop')


SCHEDULE_YAMLS = ['InstaOrderNet_o', 'InstaOrderNet_d', 'InstaOrderNet_od',
                  'OrderNet', 'OrderNet_ext']


@pytest.mark.parametrize('name', SCHEDULE_YAMLS + ['warmup'])
def test_step_lr(name):
    if name == 'warmup':
        args = (0.01, [300, 600], [0.5, 0.1], [0.1, 0.2], [100, 200])
    else:
        m = load_config(str(REPO / 'experiments' / 'InstaOrder' / name /
                            'config.yaml')).model
        args = (m['lr'], m['lr_steps'], m['lr_mults'], m['warmup_lr'],
                m['warmup_steps'])
    want, got = jstep_lr(*args), tstep_lr(*args)
    steps = range(0, 1000) if name == 'warmup' else range(0, 90001)
    w = [want(s) for s in steps]
    g = [got(s) for s in steps]
    assert g == w


@pytest.mark.parametrize('case', [(7, 5, 4, 1, 0, -1), (7, 5, 4, 3, 2, -1),
                                  (30, 9, 8, 2, 1, 3), (5, 100, 2, 1, 0, 7)])
def test_samplers(case):
    n, total_iter, bs, world, rank, last = case
    state = np.random.get_state()
    want = list(JS.DistributedGivenIterationSampler(
        n, total_iter, bs, world, rank, last))
    got = list(TS.DistributedGivenIterationSampler(
        n, total_iter, bs, world, rank, last))
    assert got == want
    np.random.set_state(state)
    assert list(TS.GivenIterationSampler(n, total_iter, bs, last)) == \
        list(JS.GivenIterationSampler(n, total_iter, bs, last))
    assert list(TS.DistributedSequentialSampler(n, world, rank)) == \
        list(JS.DistributedSequentialSampler(n, world, rank))
    # the port leaves numpy's global generator alone
    np.random.set_state(state)
    before = np.random.get_state()[1].copy()
    TS.GivenIterationSampler(n, total_iter, bs)
    np.testing.assert_array_equal(np.random.get_state()[1], before)


def test_relu_branch_matters():
    """Why the gradients are compared on one ReLU branch: here the port's
    and JAX's own forwards put a ReLU input on opposite sides of zero,
    and a leaf of JAX's plain gradient then misses the bar, while on the
    port's branch every leaf holds."""
    params, stats, cfg = jax_net(0, 2)
    algo, hyper = 'InstaOrderNet_o', {'use_rgb': True,
                                      'fused_siamese': False}
    batch = make_batch(4, 7, 2)
    masks = []
    _, gg, _, _ = port_value_and_grad(TA.make_loss(algo, NET, cfg, hyper),
                                      params, stats, batch, masks=masks)
    _, on_branch, _, _ = jax_value_and_grad(algo, cfg, hyper, params,
                                            stats, batch, masks)
    (_, _), plain = jax.jit(jax.value_and_grad(
        lambda p: JA.make_loss(algo, jresnet.apply, cfg, hyper)(
            p, stats, batch, True), has_aux=True))(params)
    assert worst(gg, plain, 'plain')[0] > 1e-4
    assert worst(gg, on_branch, 'on branch')[0] <= 1e-4



def learnable_batch(n, seed):
    """JAX's test_train_step.synthetic_occ_batch with a constant target
    (learnable by the head bias alone)."""
    rng = np.random.RandomState(seed)
    rgb = rng.rand(n, SIZE, SIZE, 3).astype(np.float32)
    m1 = np.zeros((n, SIZE, SIZE), np.float32)
    m2 = np.zeros((n, SIZE, SIZE), np.float32)
    for i in range(n):
        y1, x1 = rng.randint(5, SIZE // 2, 2)
        m1[i, y1:y1 + 20, x1:x1 + 20] = 1
        y2, x2 = rng.randint(5, SIZE // 2, 2)
        m2[i, y2:y2 + 20, x2:x2 + 20] = 1
    return {'rgb': rgb, 'modal1': m1, 'modal2': m2,
            'occ_order': np.ones((n, 2), np.float32)}


def test_bf16_compute():
    p, s, cfg = jresnet.init(jax.random.PRNGKey(6), arch='resnet50',
                             in_channels=5, num_classes=2,
                             weight_init='xavier', layers_override=LAYERS)
    params = jax.tree_util.tree_map(np.asarray, p)
    stats = jax.tree_util.tree_map(np.asarray, s)
    hyper = {'use_rgb': True, 'compute_dtype': 'bf16'}
    batch = learnable_batch(4, 13)
    wl, _ = jax.jit(lambda p_: JA.make_loss(
        'InstaOrderNet_o', jresnet.apply, cfg, hyper)(
            p_, stats, batch, True))(params)
    loss_fn = TA.make_loss('InstaOrderNet_o', NET, cfg, hyper)
    gl, gg, _, _ = port_value_and_grad(loss_fn, params, stats, batch)
    assert abs(gl - float(wl)) <= 1e-2 * abs(float(wl)), (gl, float(wl))
    assert all(g.dtype == np.float32 for g in leaves(gg))
    opt = TO.SGD(0.9, 1e-4)
    step = TST.build_train_step(loss_fn, opt)
    tp, ts = convert.to_torch(params), convert.to_torch(stats)
    to = opt.init(tp)
    tb = to_port(batch)
    losses = []
    for _ in range(10):
        tp, ts, to, logs = step(tp, ts, to, tb, 0.03)
        losses.append(float(logs['loss']))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] - 0.05, losses
    assert all(t.dtype == torch.float32 for t in tnn.tree_leaves(tp))
    assert all(t.dtype == torch.float32 for t in tnn.tree_leaves(ts))
