"""The port's legacy deocclusion nets (models/legacy.py) and the deocclusion
loss terms (losses.py) against the JAX package's on the CPU.

Each net's tree has the JAX init's structure, its arrays refilled from a
numpy seed at scales that keep every layer's activations O(1) (a random
init at xavier gain 0.02 under eval-mode BatchNorm shrinks the output to
~1e-10, where a comparison says little); the spectral-norm vectors `u`
stay unit vectors. The same tree goes to both packages (convert.to_torch,
the PConvUNet's string leaves passed through). Inputs are numpy-seeded.

Bars:
  * every forward, eval and train, held twice against JAX's: the port's
    f64 run within 1e-9 of max |JAX's f64 run| (JAX under
    jax.enable_x64: the same function, whatever the rounding; measured
    <= 9.2e-13. Both packages' BatchNorm computes in f32 for any input,
    so for these f64 runs it computes in its input's dtype, through the
    test's own copy of each package's formula: bn_in_dtype), and the
    port's f32 run within 1e-5 of max |JAX's f32 run|, or within twice
    JAX's own f32 distance from its f64 run where that is larger (a
    dozen train-mode BatchNorms amplify f32 rounding: JAX's train-mode
    AE / VAE outputs lie up to 1.7e-5 of max from its f64 run, and the
    port's f32 from JAX's up to 2.2e-5; every other forward <= 9.4e-6):
    AE w=1 and VAE w=1 (256^2, batch 1, the reparameterisation noise fed
    in from numpy), PConvUNet layer_size=5 at 64^2 (image and mask), both
    discriminators (with their activations) and the VGG16 extractor at
    64^2; the train-mode statistics and the refreshed `u` of train mode
    at the same two bars, and the eval mode's `u` unchanged;
  * the loss terms (l2_with_ignore with and without an ignore value,
    adversarial_loss of each type, real / fake, generator /
    discriminator, gram_matrix, total_variation_loss, inpainting_loss
    with and without the extractor) within 1e-5 relative (f32 means of
    ~2,000 values in other orders: measured up to 1.1e-6);
  * the gradient of inpainting_loss's sum w.r.t. the PConvUNet's
    parameters (layer_size 4 at 32^2, train mode, VGG16 extractor). The partial convolutions
    divide by the window's mask count (up to 603), so the gradient falls
    from ~0.3 at dec_1 to ~1e-12 at enc_5: a deep leaf is the small
    difference of large terms, ~1e11 x the rounding of the arithmetic.
    In f64 (JAX under jax.enable_x64, BatchNorm in f64 on both sides as
    above) the loss within 1e-9 relative and each leaf within 1e-9 of
    its max |JAX grad| (measured <= 6.4e-15): the same function. In f32 the loss within 1e-5
    of JAX's, relative, and each leaf of the port's f32 gradient within
    max(1e-4, 2 x JAX's own f32 distance from its f64 gradient) of the
    port's f64 one: no worse than JAX's f32 (whose deep leaves lie up to
    7e-2 of their max from f64; two such roundings can lie twice that
    apart, so the two f32 gradients are not held against each other);
  * vgg16_from_torch_state_dict equal to JAX's on every value.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instaorder_tpu import losses as JL
from instaorder_tpu.core import nn as JN
from instaorder_tpu.models import legacy as JLG

from instaorder_tpu_torch import convert
from instaorder_tpu_torch import losses as TL
from instaorder_tpu_torch.core import nn as TN
from instaorder_tpu_torch.core.nn import tree_cast, tree_leaves, tree_map
from instaorder_tpu_torch.models import legacy as TLG

from test_torch_train_step import one_torch_thread  # noqa: F401 (a fixture)
import torch_threads  # noqa: F401 (the suite's torch thread cap)
BAR = 1e-5
LOSS_BAR = 1e-5
GRAD_BAR = 1e-4
F64_BAR = 1e-9
# the gradient's PConvUNet depth and input side (a 2x2 bottleneck)
GRAD_LAYERS, GRAD_SIDE = 4, 32


def structure(init, *a, **kw):
    """A JAX init's trees as ShapeDtypeStructs (jax.eval_shape: no init
    runs) and its non-array outputs (cfg)."""
    box = {}

    def f(key):
        out = init(key, *a, **kw)
        box['rest'] = out[-1]
        box['trees'] = [split_strings(t) for t in out[:-1]]
        return [t for t, _ in box['trees']]
    trees = jax.eval_shape(f, jax.random.PRNGKey(0))
    return (*(merge(t) for t, (_, merge) in zip(trees, box['trees'])),
            box['rest'])


def seeded(tree, rng, parent=''):
    """`tree` (a JAX init's) with its arrays refilled from rng: conv and
    linear weights at kaiming scale, BatchNorm parameters and statistics
    near their init, `u` a unit vector; strings kept."""
    if isinstance(tree, dict):
        return {k: seeded(v, rng, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [seeded(v, rng, parent) for v in tree]
    if isinstance(tree, str):
        return tree
    shape = tuple(np.shape(tree))
    if parent == 'u':
        u = rng.randn(*shape)
        return (u / np.linalg.norm(u)).astype(np.float32)
    if len(shape) in (2, 4):
        fan_in = int(np.prod(shape[:-1]))
        return (rng.randn(*shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)
    if parent == 'var':
        return rng.uniform(0.5, 1.5, shape).astype(np.float32)
    if parent == 'scale':
        return (1.0 + 0.1 * rng.randn(*shape)).astype(np.float32)
    return (0.1 * rng.randn(*shape)).astype(np.float32)


def jtree(tree):
    """A numpy tree on JAX's side: arrays as jnp arrays, strings kept."""
    return jax.tree_util.tree_map(
        lambda a: a if isinstance(a, str) else jnp.asarray(a), tree)


def both(p, s):
    """(JAX's tree, the port's) of a numpy tree pair."""
    return ((jtree(p), jtree(s)), (convert.to_torch(p), convert.to_torch(s)))


def split_strings(tree):
    """(the tree without its string leaves, a function putting them back):
    a jitted JAX function takes the arrays only."""
    def strip(t):
        if isinstance(t, dict):
            return {k: strip(v) for k, v in t.items()
                    if not isinstance(v, str)}
        return t

    def merge(arrays, t=tree):
        if isinstance(t, dict):
            return {k: (v if isinstance(v, str) else merge(arrays[k], v))
                    for k, v in t.items()}
        return arrays
    return strip(tree), merge


def leaves(out):
    if isinstance(out, (tuple, list)):
        return [x for o in out for x in leaves(o)]
    if isinstance(out, dict):
        return [x for k in sorted(out) for x in leaves(out[k])]
    return [np.asarray(out.detach() if hasattr(out, 'detach') else out,
                       np.float64)]


def assert_close(got, want, bar=BAR, what=''):
    """Each leaf of got within `bar` of max |want|."""
    g, w = leaves(got), leaves(want)
    assert len(g) == len(w), what
    for a, b in zip(g, w):
        assert a.shape == b.shape, (what, a.shape, b.shape)
        err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
        assert err <= bar, (what, err, bar)


def jax_batch_norm_in_dtype(params, stats, x, train, momentum=0.1,
                            eps=1e-5):
    """JAX's core.nn.batch_norm with its f32 casts made casts to x's
    dtype (f32 at least)."""
    ct = jnp.promote_types(x.dtype, jnp.float32)
    if train:
        axes = tuple(range(x.ndim - 1))
        xf = x.astype(ct)
        mean, var = jnp.mean(xf, axes), jnp.var(xf, axes)
        n = x.size // x.shape[-1]
        unbiased = var * (n / max(n - 1, 1))
        new_stats = {
            'mean': (1 - momentum) * stats['mean'].astype(ct) + momentum * mean,
            'var': (1 - momentum) * stats['var'].astype(ct)
            + momentum * unbiased}
    else:
        mean, var = stats['mean'].astype(ct), stats['var'].astype(ct)
        new_stats = stats
    inv = jax.lax.rsqrt(var + eps) * params['scale'].astype(ct)
    out = (x.astype(ct) - mean) * inv + params['bias'].astype(ct)
    return out.astype(x.dtype), new_stats


def port_batch_norm_eval_in_dtype(params, stats, x, eps=1e-5):
    """The port's core.nn.batch_norm_eval with its f32 casts made casts to
    x's dtype (f32 at least); its train branch already keeps f64."""
    ct = torch.promote_types(x.dtype, torch.float32)
    inv = torch.rsqrt(stats['var'].to(ct) + eps) * params['scale'].to(ct)
    out = (x.to(ct) - stats['mean'].to(ct)) * inv + params['bias'].to(ct)
    return out.to(x.dtype)


@contextlib.contextmanager
def bn_in_dtype():
    """Both packages' BatchNorm computing in its input's dtype."""
    orig = JN.batch_norm, TN.batch_norm_eval
    JN.batch_norm = jax_batch_norm_in_dtype
    TN.batch_norm_eval = port_batch_norm_eval_in_dtype
    try:
        yield
    finally:
        JN.batch_norm, TN.batch_norm_eval = orig


def jax_f32_f64(fn, *args):
    """fn jitted on args (trees and arrays, strings kept) at f32 and, under
    jax.enable_x64, on the same values cast to f64."""
    want = jax.jit(fn)(*args)
    with jax.enable_x64(True), bn_in_dtype():
        cast = lambda t: jax.tree_util.tree_map(  # noqa: E731
            lambda a: a if isinstance(a, str)
            else jnp.asarray(np.asarray(a), jnp.float64), t)
        want64 = jax.jit(fn)(*map(cast, args))
    return want, want64


def assert_matches_jax(got, got64, want, want64, what=''):
    """The port's f64 run within F64_BAR of max |JAX's f64 run|; its f32
    run within max(BAR, 2 x JAX's own f32 distance from its f64 run) of
    max |JAX's f32 run|."""
    assert_close(got64, want64, F64_BAR, what + ' f64')
    g, w, w64 = leaves(got), leaves(want), leaves(want64)
    assert len(g) == len(w) == len(w64), what
    for a, b, c in zip(g, w, w64):
        assert a.shape == b.shape, (what, a.shape, b.shape)
        scale = max(np.abs(b).max(), 1e-30)
        err = np.abs(a - b).max() / scale
        lim = max(BAR, 2 * np.abs(b - c).max() / scale)
        assert err <= lim, (what, err, lim)


def f64_run(apply, *trees_and_inputs, **kw):
    """apply on every tensor of its arguments cast to f64, BatchNorm
    computing in f64."""
    with bn_in_dtype():
        return apply(*(tree_cast(a, torch.float64)
                       if isinstance(a, (dict, list))
                       else a.double() if isinstance(a, torch.Tensor) else a
                       for a in trees_and_inputs), **kw)


def image(seed, n, h, c):
    return np.random.RandomState(seed).randn(n, h, h, c).astype(np.float32)


@pytest.mark.parametrize('variational', [False, True])
@pytest.mark.parametrize('train', [False, True])
def test_ae_matches_jax(variational, train):
    """AE / VAE at w=1 (the factories' structure at a quarter width) on
    256^2; the VAE's noise from numpy."""
    kw = dict(in_channels=3, w=1, latent_dim=32, variational=variational)
    p, s, cfg = structure(JLG.ae_init, **kw)
    rng = np.random.RandomState(1)
    (jp, js), (tp, ts) = both(seeded(p, rng), seeded(s, rng))
    x = image(2, 1, 256, 3)
    eps = np.random.RandomState(3).randn(1, 32).astype(np.float32)
    # JAX's VAE draws its noise from its key: both take numpy's
    orig = JLG.jax.random.normal
    JLG.jax.random.normal = lambda key, shape, dtype: jnp.asarray(eps, dtype)
    try:
        (want, wst), (w64, ws64) = jax_f32_f64(
            lambda p, s, x: JLG.ae_apply(p, s, cfg, x, train=train,
                                         rng=jax.random.PRNGKey(9)),
            jp, js, jnp.asarray(x))
    finally:
        JLG.jax.random.normal = orig
    e = torch.from_numpy(eps) if train else None
    got, gst = TLG.ae_apply(tp, ts, cfg, torch.from_numpy(x), train=train,
                            eps=e)
    r64, s64 = f64_run(TLG.ae_apply, tp, ts, cfg, torch.from_numpy(x),
                       train=train, eps=None if e is None else e.double())
    assert_matches_jax(got, r64, want, w64, 'ae out')
    assert_matches_jax(gst, s64, wst, ws64, 'ae stats')
    if variational and train:
        # a generator's draw goes the same way as the fed noise
        gen = torch.Generator().manual_seed(0)
        e2 = torch.randn((1, 32), generator=torch.Generator().manual_seed(0))
        a, _ = TLG.ae_apply(tp, ts, cfg, torch.from_numpy(x), train=True,
                            rng=gen)
        b, _ = TLG.ae_apply(tp, ts, cfg, torch.from_numpy(x), train=True,
                            eps=e2)
        torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)


def test_ae_registry_widths():
    """AE256 / AE32 / VAE32: the port's init has JAX's structure and
    shapes (no forward: eval_shape only on JAX's side)."""
    for name, kw in TLG.AE_FACTORIES.items():
        box = {}

        def f(key):
            p, s, box['cfg'] = JLG.ae_init(key, **kw)
            return p, s
        jp, js = jax.eval_shape(f, jax.random.PRNGKey(0))
        tp, ts, cfg = TLG.ae_init(torch.Generator().manual_seed(0), **kw)
        assert cfg == box['cfg'], name
        for t, j in ((tp, jp), (ts, js)):
            assert (jax.tree_util.tree_structure(convert.to_numpy(t))
                    == jax.tree_util.tree_structure(j)), name
            assert ([x.shape for x in jax.tree_util.tree_leaves(
                convert.to_numpy(t))] ==
                    [tuple(x.shape) for x in jax.tree_util.tree_leaves(j)])


def pconv_nets(layer_size=5):
    p, s, cfg = structure(JLG.pconv_unet_init, layer_size=layer_size)
    rng = np.random.RandomState(4)
    return seeded(p, rng), seeded(s, rng), cfg


def pconv_inputs(size=64, seed=5):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, size, size, 3).astype(np.float32)
    mask = np.ones((2, size, size, 3), np.float32)
    for i in range(2):
        y0, x0 = rng.randint(0, size // 2, 2)
        mask[i, y0:y0 + size // 3, x0:x0 + size // 2] = 0
    return x, mask


@pytest.mark.parametrize('train', [False, True])
def test_pconv_unet_matches_jax(train):
    p, s, cfg = pconv_nets()
    (jp, js), (tp, ts) = both(p, s)
    assert tp['enc_1']['sample'] == 'down-7'
    assert convert.to_numpy(tp)['enc_1']['sample'] == 'down-7'
    x, m = pconv_inputs()
    arrays, merge = split_strings(jp)
    (want, wst), (w64, ws64) = jax_f32_f64(
        lambda a, s, x, m: JLG.pconv_unet_apply(merge(a), s, cfg, x, m,
                                                train=train),
        arrays, js, jnp.asarray(x), jnp.asarray(m))
    got, gst = TLG.pconv_unet_apply(tp, ts, cfg, torch.from_numpy(x),
                                    torch.from_numpy(m), train=train)
    r64, s64 = f64_run(TLG.pconv_unet_apply, tp, ts, cfg,
                       torch.from_numpy(x), torch.from_numpy(m), train=train)
    assert_matches_jax(got, r64, want, w64, 'pconv out')
    assert_matches_jax(gst, s64, wst, ws64, 'pconv stats')


def test_partial_conv_holes_match_jax():
    """A mask with holes wider than the window: the hole outputs 0, the
    new mask 0 there, at each sampling mode."""
    rng = np.random.RandomState(6)
    x = rng.randn(1, 24, 24, 4).astype(np.float32)
    m = np.ones_like(x)
    m[:, 4:16, 6:20] = 0
    m[:, 18:, :, 1] = 0
    for ksz, stride, pad in TLG._SAMPLES.values():
        w = rng.randn(ksz, ksz, 4, 5).astype(np.float32)
        b = rng.randn(5).astype(np.float32)
        want = JLG.partial_conv({'w': jnp.asarray(w), 'b': jnp.asarray(b)},
                                jnp.asarray(x), jnp.asarray(m), stride, pad)
        got = TLG.partial_conv({'w': torch.from_numpy(w),
                                'b': torch.from_numpy(b)},
                               torch.from_numpy(x), torch.from_numpy(m),
                               stride, pad)
        assert_close(got, want, what=f'partial_conv k{ksz}')
        assert (np.asarray(want[1]) == 0).any()


@pytest.mark.parametrize('kind', ['inpaint', 'nlayer'])
@pytest.mark.parametrize('train', [False, True])
def test_discriminators_match_jax(kind, train):
    if kind == 'inpaint':
        p, s, cfg = structure(JLG.inpaint_discriminator_init, 4)
        japply, tapply = (JLG.inpaint_discriminator_apply,
                          TLG.inpaint_discriminator_apply)
    else:
        p, s, cfg = structure(JLG.nlayer_discriminator_init, 4)
        japply, tapply = (JLG.nlayer_discriminator_apply,
                          TLG.nlayer_discriminator_apply)
    rng = np.random.RandomState(7)
    (jp, js), (tp, ts) = both(seeded(p, rng), seeded(s, rng))
    x = image(8, 2, 64, 4)
    (want, wst), (w64, ws64) = jax_f32_f64(
        lambda p, s, x: japply(p, s, cfg, x, train=train), jp, js,
        jnp.asarray(x))
    got, gst = tapply(tp, ts, cfg, torch.from_numpy(x), train=train)
    r64, s64 = f64_run(tapply, tp, ts, cfg, torch.from_numpy(x), train=train)
    assert_matches_jax(got, r64, want, w64, f'{kind} out')
    assert_matches_jax(gst, s64, wst, ws64, f'{kind} u')
    if not train:
        assert all((a == b).all() for a, b in zip(leaves(gst), leaves(ts)))


def vgg_nets():
    p, cfg = structure(JLG.vgg16_extractor_init)
    p = seeded(p, np.random.RandomState(10))
    return jax.tree_util.tree_map(jnp.asarray, p), convert.to_torch(p), cfg


def test_vgg16_extractor_matches_jax():
    jp, tp, cfg = vgg_nets()
    x = image(11, 2, 64, 3)
    assert_close(TLG.vgg16_extractor_apply(tp, cfg, torch.from_numpy(x)),
                 jax.jit(lambda p, x: JLG.vgg16_extractor_apply(p, cfg, x))(
                     jp, jnp.asarray(x)), what='vgg16')


def test_vgg16_from_torch_state_dict_matches_jax():
    rng = np.random.RandomState(12)
    sd, cin = {}, 3
    for li, cout in zip((0, 2, 5, 7, 10, 12, 14),
                        (64, 64, 128, 128, 256, 256, 256)):
        sd[f'features.{li}.weight'] = torch.from_numpy(
            rng.randn(cout, cin, 3, 3).astype(np.float32))
        sd[f'features.{li}.bias'] = torch.from_numpy(
            rng.randn(cout).astype(np.float32))
        cin = cout
    want = JLG.vgg16_from_torch_state_dict(sd)
    got = TLG.vgg16_from_torch_state_dict(sd)
    assert_close(got, want, bar=0.0)


def test_loss_terms_match_jax():
    rng = np.random.RandomState(13)
    pred = rng.randn(2, 8, 9).astype(np.float32)
    target = rng.randint(0, 4, (2, 8, 9)).astype(np.float32)
    for ign in (None, 3):
        assert_close(TL.l2_with_ignore(torch.from_numpy(pred),
                                       torch.from_numpy(target), ign),
                     JL.l2_with_ignore(jnp.asarray(pred),
                                       jnp.asarray(target), ign),
                     LOSS_BAR, f'l2 {ign}')
    prob = rng.uniform(0.01, 0.99, (2, 5, 5, 1)).astype(np.float32)
    logit = rng.randn(2, 5, 5, 1).astype(np.float32)
    for kind, o in (('nsgan', prob), ('lsgan', logit), ('hinge', logit)):
        for real in (True, False):
            for disc in (True, False):
                assert_close(
                    TL.adversarial_loss(torch.from_numpy(o), real, disc,
                                        kind),
                    JL.adversarial_loss(jnp.asarray(o), real, disc, kind),
                    LOSS_BAR, f'{kind} {real} {disc}')
    with pytest.raises(ValueError):
        TL.adversarial_loss(torch.from_numpy(o), True, loss_type='wgan')
    feat = rng.randn(2, 6, 7, 5).astype(np.float32)
    assert_close(TL.gram_matrix(torch.from_numpy(feat)),
                 JL.gram_matrix(jnp.asarray(feat)), LOSS_BAR, 'gram')
    assert_close(TL.total_variation_loss(torch.from_numpy(feat)),
                 JL.total_variation_loss(jnp.asarray(feat)), LOSS_BAR, 'tv')
    jp, tp, cfg = vgg_nets()
    for c in (3, 1):
        inp, gt, out = (rng.randn(2, 32, 32, c).astype(np.float32)
                        for _ in range(3))
        mask = (rng.rand(2, 32, 32, c) > 0.4).astype(np.float32)
        for ext in (False, True):
            want = JL.inpainting_loss(
                *map(jnp.asarray, (inp, mask, out, gt)),
                extractor=(lambda im: JLG.vgg16_extractor_apply(jp, cfg, im))
                if ext else None)
            got = TL.inpainting_loss(
                *map(torch.from_numpy, (inp, mask, out, gt)),
                extractor=(lambda im: TLG.vgg16_extractor_apply(tp, cfg, im))
                if ext else None)
            assert set(got) == set(want)
            for k in want:
                assert_close(got[k], want[k], LOSS_BAR, f'{k} c{c} {ext}')


def test_inpainting_gradient_matches_jax():
    """d(sum of inpainting_loss) / d(PConvUNet params), train mode, with
    the VGG16 extractor: JAX's value_and_grad against autograd, in f64
    and in f32."""
    p, s, cfg = pconv_nets(GRAD_LAYERS)
    jv, tv, vcfg = vgg_nets()
    x, m = pconv_inputs(size=GRAD_SIDE, seed=14)
    gt = image(15, 2, GRAD_SIDE, 3)
    arrays, merge = split_strings(p)

    def jgrad(dt):
        cast = lambda t: jax.tree_util.tree_map(  # noqa: E731
            lambda a: jnp.asarray(a, dt), t)

        def loss(a):
            (out, _), _ = JLG.pconv_unet_apply(
                merge(a), cast(s), cfg, cast(x), cast(m), train=True)
            terms = JL.inpainting_loss(
                cast(x), cast(m), out, cast(gt),
                extractor=lambda im: JLG.vgg16_extractor_apply(
                    cast(jv), vcfg, im))
            return sum(terms.values())
        v, g = jax.jit(jax.value_and_grad(loss))(cast(arrays))
        return float(v), [np.asarray(a, np.float64)
                          for a in jax.tree_util.tree_leaves(g)]

    def tgrad(dt):
        tparams = tree_cast(convert.to_torch(arrays), dt)
        for t in tree_leaves(tparams):
            t.requires_grad_(True)
        X = lambda a: torch.from_numpy(a).to(dt)  # noqa: E731
        (out, _), _ = TLG.pconv_unet_apply(merge(tparams),
                                           tree_cast(convert.to_torch(s), dt),
                                           cfg, X(x), X(m), train=True)
        terms = TL.inpainting_loss(
            X(x), X(m), out, X(gt),
            extractor=lambda im: TLG.vgg16_extractor_apply(
                tree_cast(tv, dt), vcfg, im))
        loss = sum(terms.values())
        loss.backward()
        return float(loss), jax.tree_util.tree_leaves(convert.to_numpy(
            tree_map(lambda t: t.grad.double(), tparams)))

    with jax.enable_x64(True), bn_in_dtype():
        jl64, jg64 = jgrad(jnp.float64)
    jl, jg = jgrad(jnp.float32)
    with bn_in_dtype():
        tl64, tg64 = tgrad(torch.float64)
    tl, tg = tgrad(torch.float32)
    assert abs(tl64 - jl64) <= F64_BAR * abs(jl64)
    assert abs(tl - jl) <= BAR * abs(jl)
    assert len(tg) == len(jg) == len(jg64) == len(tg64)
    for g, w, g64, w64 in zip(tg, jg, tg64, jg64):
        scale = np.abs(w64).max()
        assert np.abs(g64 - w64).max() <= F64_BAR * scale
        lim = max(GRAD_BAR, 2 * np.abs(w - w64).max() / scale)
        assert np.abs(g - g64).max() <= lim * scale, (
            np.abs(g - g64).max() / scale, lim)
