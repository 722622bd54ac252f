"""Each ported algorithm's loss, gradients and new BatchNorm statistics,
and the train step, against the JAX package's on the CPU.

The nets are resnet50_cls with layers_override (1, 1, 1, 1) at 64x64,
initialised in JAX (kaiming, from a seed) and carried across with
convert.py; the batches (4 pairs) come from numpy seeds.

The gradients are compared on one branch of the network's ReLUs: the
port's forward records which ReLU inputs are positive, and JAX's
forward, traced with `jax.nn.relu` replaced by a select on those masks,
follows the same branch. The gradient of a ReLU network jumps where an
input crosses zero, and two f32 forwards (XLA's and PyTorch's
convolutions sum in other orders) put about one element of this
network's ~10^6 ReLU inputs on opposite sides of zero; that one element
moves a column of some weight gradient by up to ~20% of the leaf's max
(test_torch_train_core.py's `test_relu_branch_matters` shows such
a case). On one branch the
functions are the same and the bars below hold. Bars:
  * loss within 1e-5 relative of jax.value_and_grad's;
  * every gradient leaf within 1e-4 of that leaf's max |JAX grad|;
  * the new statistics within 1e-5 of max |JAX|;
  * one build_train_step step (SGD, momentum, weight decay) against
    JAX's on a 1-device mesh: the new params within 1e-4 of each leaf's
    max |update| (the gradients' bar: an update is lr * (grad + wd * p);
    the stem's bn1 bias, a sum over every pixel, gives ~2e-5), plus one
    f32 spacing of the new value (where |p| is far above the update, as
    for a BatchNorm scale near 1, the rounding of p - lr * buf alone is
    ~1e-4 of the update);
  * remat: loss and gradients equal to the plain forward's within 1e-6.
The sequential siamese mode and the eval loss are held in
test_torch_train_seq.py, compute_dtype bf16 and the ReLU-branch case in
test_torch_train_core.py (with these helpers), so that each file runs
in under a minute.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instaorder_tpu.models import resnet as jresnet
from instaorder_tpu.parallel import make_mesh, shard_batch
from instaorder_tpu.train import algos as JA
from instaorder_tpu.train import optim as JO
from instaorder_tpu.train import step as JST

from instaorder_tpu_torch import convert
from instaorder_tpu_torch.core.nn import tree_leaves, tree_unflatten
from instaorder_tpu_torch.models.registry import get_backbone
from instaorder_tpu_torch.train import algos as TA
from instaorder_tpu_torch.train import optim as TO
from instaorder_tpu_torch.train import step as TST
import torch_threads  # noqa: F401 (the suite's torch thread cap)

LAYERS = (1, 1, 1, 1)
SIZE = 64
NET = get_backbone('resnet50_cls')
DEPTH_W = {'overlap_weight': 0.1, 'distinct_weight': 0.9}
# (case, algo, classes, hyper)
CASES = [
    ('o', 'InstaOrderNet_o', 2, {'use_rgb': True}),
    ('ordernet3', 'OrderNet', 3, {'use_rgb': True}),
    ('ordernet4', 'OrderNet_ext', 4, {'use_rgb': True}),
    ('d', 'InstaOrderNet_d', 3, dict(DEPTH_W, use_rgb=True)),
    ('od', 'InstaOrderNet_od', [2, 3], dict(DEPTH_W)),
]


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """PyTorch's CPU ops on one thread while this module runs: the suite
    runs several workers at once, and bf16 convolutions oversubscribed
    across them ran ~35x slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_batch(n, seed, classes):
    """Rectangle masks, random RGB and every label field, from a seed."""
    rng = np.random.RandomState(seed)
    rgb = rng.randn(n, SIZE, SIZE, 3).astype(np.float32)
    m1 = np.zeros((n, SIZE, SIZE), np.float32)
    m2 = np.zeros((n, SIZE, SIZE), np.float32)
    for i in range(n):
        y, x = rng.randint(0, SIZE // 2, 2)
        m1[i, y:y + 24, x:x + 24] = 1
        y, x = rng.randint(0, SIZE // 2, 2)
        m2[i, y:y + 24, x:x + 24] = 1
    depth = rng.randint(0, 3, n).astype(np.int32)
    depth[0] = -1                      # an unlabelled pair
    overlap = np.array([1, 0] * (n // 2), np.int32)
    return {'rgb': rgb, 'modal1': m1, 'modal2': m2,
            'occ_order': rng.randint(0, 2, (n, 2)).astype(np.float32),
            'depth_order': depth, 'is_overlap': overlap,
            'count': rng.randint(1, 4, n).astype(np.int32),
            'label': rng.randint(0, 4 if classes == 4 else 3,
                                 n).astype(np.int32)}


def to_port(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def jax_net(seed, classes):
    p, s, cfg = jresnet.init(jax.random.PRNGKey(seed), arch='resnet50',
                             in_channels=5, num_classes=classes,
                             weight_init='kaiming_out',
                             layers_override=LAYERS)
    return (jax.tree_util.tree_map(np.asarray, p),
            jax.tree_util.tree_map(np.asarray, s), cfg)


@contextlib.contextmanager
def recorded_relu(masks):
    """torch.relu records `x > 0` of every input into `masks`."""
    real = torch.relu

    def relu(x):
        masks.append((x > 0).detach().numpy())
        return real(x)
    torch.relu = relu
    try:
        yield masks
    finally:
        torch.relu = real


@contextlib.contextmanager
def relu_on(masks):
    """jax.nn.relu, while a forward is traced, selects on `masks` (the
    port's branch, in call order) instead of testing x > 0."""
    real = jax.nn.relu
    it = iter(masks)

    def relu(x):
        m = next(it)
        assert m.shape == x.shape, (m.shape, x.shape)
        return jnp.where(m, x, jnp.zeros((), x.dtype))
    jax.nn.relu = relu
    try:
        yield
    finally:
        jax.nn.relu = real
    assert next(it, None) is None, 'JAX ran fewer ReLUs than the port'


def jax_value_and_grad(algo, cfg, hyper, params, stats, batch, masks):
    """(loss, grads, new_stats, logs) of JAX's loss_fn on the port's ReLU
    branch, numpy."""
    loss_fn = JA.make_loss(algo, jresnet.apply, cfg, hyper)
    with relu_on(masks):
        (loss, (ns, logs)), g = jax.jit(jax.value_and_grad(
            lambda p: loss_fn(p, stats, batch, True),
            has_aux=True))(params)
    return (float(loss), jax.tree_util.tree_map(np.asarray, g),
            jax.tree_util.tree_map(np.asarray, ns),
            {k: float(v) for k, v in logs.items()})


def port_value_and_grad(loss_fn, params, stats, batch, train=True,
                        masks=None):
    """(loss, grads, new_stats, logs) of the port's loss_fn, numpy; the
    ReLU masks of its forward are appended to `masks` when given."""
    leaves = [t.requires_grad_(True)
              for t in tree_leaves(convert.to_torch(params))]
    rec = recorded_relu(masks) if masks is not None \
        else contextlib.nullcontext()
    with rec:
        loss, (new_stats, logs) = loss_fn(
            tree_unflatten(convert.to_torch(params), leaves),
            convert.to_torch(stats), to_port(batch), train)
    grads = torch.autograd.grad(loss, leaves)
    return (float(loss.detach()),
            convert.to_numpy(tree_unflatten(params, grads)),
            convert.to_numpy(new_stats), logs)


def leaves(tree):
    return jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray,
                                                            tree))


def worst(got, want, what):
    """Max over leaves of max|got - want| / max|want| (a leaf of zeros
    compares absolutely); returns (err, leaf index)."""
    out = (0.0, -1)
    g, w = leaves(got), leaves(want)
    assert len(g) == len(w), what
    for i, (a, b) in enumerate(zip(g, w)):
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        assert a.shape == b.shape, (what, i, a.shape, b.shape)
        err = float(np.abs(a - b).max()) / max(float(np.abs(b).max()),
                                               1e-30 if b.any() else 1.0)
        out = max(out, (err, i))
    return out


@pytest.fixture(scope='module')
def nets():
    return {str(c): jax_net(i, c) for i, c in enumerate((2, 3, 4, [2, 3]))}


def check_loss_grads_stats(nets, case, fused):
    """The bars of the module docstring for one algorithm and mode."""
    _, algo, classes, hyper = case
    hyper = dict(hyper, fused_siamese=fused)
    params, stats, cfg = nets[str(classes)]
    batch = make_batch(4, 7, classes)
    tloss = TA.make_loss(algo, NET, cfg, hyper)
    masks = []
    gl, gg, gs, glogs = port_value_and_grad(tloss, params, stats, batch,
                                            masks=masks)
    wl, wg, ws, wlogs = jax_value_and_grad(algo, cfg, hyper, params, stats,
                                           batch, masks)
    assert abs(gl - wl) <= 1e-5 * abs(wl), (gl, wl)
    assert sorted(glogs) == sorted(wlogs)
    for k in glogs:
        assert glogs[k].requires_grad is False
        np.testing.assert_allclose(float(glogs[k]), wlogs[k], rtol=1e-5)
    err, leaf = worst(gg, wg, 'grads')
    assert err <= 1e-4, f'worst gradient leaf {leaf}: {err:.3e}'
    err, leaf = worst(gs, ws, 'stats')
    assert err <= 1e-5, f'worst stats leaf {leaf}: {err:.3e}'


@pytest.mark.parametrize('case', CASES, ids=[c[0] for c in CASES])
def test_loss_grads_stats(nets, case):
    """The fused siamese forward (one 2N batch); the sequential one is
    in test_torch_train_seq.py."""
    check_loss_grads_stats(nets, case, fused=True)


def test_train_step_against_jax(nets):
    """One SGD step (momentum, weight decay) through build_train_step
    against JAX's on a 1-device mesh."""
    params, stats, cfg = nets['2']
    hyper = {'use_rgb': True}
    batch = make_batch(4, 11, 2)
    jopt, topt = JO.SGD(0.9, 1e-4), TO.SGD(0.9, 1e-4)
    tparams = convert.to_torch(params)
    tstep = TST.build_train_step(
        TA.make_loss('InstaOrderNet_o', NET, cfg, hyper), topt)
    with recorded_relu([]) as masks:
        tp, ts, to, tlogs = tstep(tparams, convert.to_torch(stats),
                                  topt.init(tparams), to_port(batch), 0.01)
    mesh = make_mesh(1)
    jstep = JST.build_train_step(
        JA.make_loss('InstaOrderNet_o', jresnet.apply, cfg, hyper), jopt,
        mesh)
    with relu_on(masks):
        jp, js, jo, jlogs = jstep(
            jax.tree_util.tree_map(jnp.asarray, params), stats,
            jopt.init(params), shard_batch(batch, mesh), 0.01)
    np.testing.assert_allclose(float(tlogs['loss']), float(jlogs['loss']),
                               rtol=1e-5)
    # the inputs are left as they were
    for a, b in zip(tree_leaves(tparams), tree_leaves(
            convert.to_torch(params))):
        assert torch.equal(a, b) and not a.requires_grad
    g, w, p0 = leaves(convert.to_numpy(tp)), leaves(jp), leaves(params)
    for i, (a, b, c) in enumerate(zip(g, w, p0)):
        upd = float(np.abs(b - c).max())
        excess = np.abs(a - b) - np.spacing(np.abs(b).astype(np.float32))
        err = float(excess.max()) / upd
        assert err <= 1e-4, f'param leaf {i}: {err:.3e} of max |update|'
    err, leaf = worst(convert.to_numpy(ts), js, 'stats')
    assert err <= 1e-5, (leaf, err)
    err, leaf = worst(convert.to_numpy(to), jo, 'opt_state')
    assert err <= 1e-4, (leaf, err)


@pytest.mark.parametrize('fused', [True, False], ids=['fused', 'sequential'])
def test_remat(nets, fused):
    params, stats, cfg = nets['[2, 3]']
    hyper = dict(DEPTH_W, fused_siamese=fused)
    batch = make_batch(2, 17, [2, 3])
    base = port_value_and_grad(
        TA.make_loss('InstaOrderNet_od', NET, cfg, hyper), params, stats,
        batch)
    rem = port_value_and_grad(
        TA.make_loss('InstaOrderNet_od', NET, cfg, dict(hyper, remat=True)),
        params, stats, batch)
    assert abs(rem[0] - base[0]) <= 1e-6 * abs(base[0])
    for what, k in (('grads', 1), ('stats', 2)):
        err, leaf = worst(rem[k], base[k], what)
        assert err <= 1e-6, (what, leaf, err)


def test_not_ported_algos():
    """Every training algorithm of the JAX package is ported: no refusal
    is left (the InstaDepthNet ones are held against JAX in
    tests/test_torch_depth_train.py, PartialCompletionMask in
    tests/test_torch_unet.py)."""
    assert not hasattr(TA, 'NOT_PORTED') and not hasattr(TA, 'check_ported')
    hyper = {'overlap_weight': 0, 'distinct_weight': 0, 'smooth_weight': 0.1,
             'dorder_weight': 1}
    for algo in ('InstaDepthNet_d', 'InstaDepthNet_od',
                 'PartialCompletionMask'):
        assert callable(TA.make_loss(algo, NET, {}, hyper))
    with pytest.raises(KeyError):
        TA.make_loss('nope', NET, {}, {})
    assert sorted(TA.ALGOS) == sorted(JA.ALGOS)


def test_build_forward(nets):
    """build_forward: the eval forward, or the train forward's output,
    without autograd."""
    params, stats, cfg = nets['[2, 3]']
    tp, ts = convert.to_torch(params), convert.to_torch(stats)
    x = torch.from_numpy(np.random.RandomState(3).randn(
        2, SIZE, SIZE, 5).astype(np.float32))
    for train in (False, True):
        got = TST.build_forward(NET, cfg, train=train)(tp, ts, x)
        want = NET['apply_train'](tp, ts, cfg, x)[0] if train else \
            NET['apply'](tp, ts, cfg, x)
        for g, w in zip(got, want):
            assert not g.requires_grad
            assert torch.equal(g, w.detach())
