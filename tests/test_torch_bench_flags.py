"""The port's bench flags against the root bench.py on the CPU:
--directions, --prep-precision, --prep-stage1 and --no-pallas.

  * serving.resolve_profile (through the port bench's own parser) equals
    the root bench's resolve_profile over every profile x --directions x
    --prep-precision x --dtype x --prep-rgb combination (the root's is
    pinned by tests/test_bench_profiles.py), --dtype f32 included;
  * the einsum prep at 'highest' against JAX build_pair_batch_matmul
    (precision=HIGHEST); at 'high', 'default' and stage1 bf16 against a
    JAX einsum written here whose operands are split or cast as the TPU
    precisions do (JAX on the CPU computes every precision in f32, so
    its own `precision` argument cannot be the reference there). Bar:
    the prep bar (masks exact, RGB within one uint8 LSB on under 1% of
    pixels);
  * --no-pallas calls no kernel wrapper of the model, whatever the
    dtype, and leaves the prep route alone (wrapper calls counted on the
    CPU);
  * vs_baseline divides by a rate measured on the H100
    (bench.BASELINE_PAIRS_PER_S, stated in bench.py's docstring), and no
    file of the port's bench (bench.py, serving.py, trace.py) names the
    TPU round's 10,000 pairs/s.
"""

import functools
import importlib.util
import itertools
import os
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from instaorder_tpu.ops import pairs as JP

from instaorder_tpu_torch import bench as tbench
from instaorder_tpu_torch import serving
from instaorder_tpu_torch.models import folding as TF
from instaorder_tpu_torch.models import quantize as TQ
from instaorder_tpu_torch.ops import bottleneck_bf16_kernels as bk16
from instaorder_tpu_torch.ops import bottleneck_kernels as bk
from instaorder_tpu_torch.ops import int8_kernels as ik
from instaorder_tpu_torch.ops import pairs as TP
from instaorder_tpu_torch.ops import prep_kernels as PK
import torch_threads  # noqa: F401 (the suite's torch thread cap)

OUT = 64
LSB = 1.0 / (255 * 0.224) + 1e-6
_BENCH = os.path.join(os.path.dirname(__file__), os.pardir, 'bench.py')


@pytest.fixture(scope='module')
def root_bench():
    spec = importlib.util.spec_from_file_location('root_bench', _BENCH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


COMBOS = list(itertools.product(
    [None, '1', '2'], [None, 'default', 'high', 'highest'],
    [None, 'bf16', 'f32', 'int8', 'int8c'], [None, 'einsum', 'pallas5']))


@pytest.mark.parametrize('profile', ['serving-d1', 'serving-d2', 'parity'])
def test_resolve_profile_matches_root_bench(root_bench, profile):
    for directions, precision, dtype, prep_rgb in COMBOS:
        argv = ['--profile', profile]
        for flag, v in (('--directions', directions),
                        ('--prep-precision', precision),
                        ('--dtype', dtype), ('--prep-rgb', prep_rgb)):
            if v is not None:
                argv += [flag, v]
        want = root_bench.resolve_profile(
            root_bench.build_parser().parse_args(argv))
        if dtype == 'f32':
            # the port resolves --dtype f32 as the root does: the dtype
            # is a choice of both parsers and the profile's other
            # settings do not depend on it
            assert 'f32' in serving.DTYPES
            assert serving.resolve_profile(profile, dtype='f32')[
                'dtype'] == want.dtype == 'f32'
        got = tbench.resolve(tbench.build_parser().parse_args(argv))
        assert (got['dtype'], got['directions'], got['prep_rgb'],
                got['prep_precision']) == (want.dtype, want.directions,
                                           want.prep_rgb,
                                           want.prep_precision), argv
        # root bench.py prep_all: passes = 1 at 'default', else 3
        assert got['passes'] == (1 if want.prep_precision == 'default'
                                 else 3)


def test_bench_parser_takes_the_root_flags():
    args = tbench.build_parser().parse_args(
        ['--no-pallas', '--prep-stage1', 'bf16', '--directions', '2',
         '--prep-precision', 'highest'])
    assert args.no_pallas and args.prep_stage1 == 'bf16'
    assert tbench.use_pallas_of(args) is False
    args = tbench.build_parser().parse_args([])
    assert tbench.use_pallas_of(args) is True and args.prep_stage1 == 'f32'
    args = tbench.build_parser().parse_args(['--pallas-features', 'hwnc,down2'])
    assert tbench.use_pallas_of(args) == ('hwnc', 'down2')
    for bad in (['--directions', '3'], ['--prep-precision', 'low'],
                ['--prep-stage1', 'f16']):
        with pytest.raises(SystemExit):
            tbench.build_parser().parse_args(bad)


def _scenes(seed=0, S=2, H=96, W=128, N=4):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 255, (S, H, W, 3)).astype(np.float32)
    masks = np.zeros((S, N, H, W), np.float32)
    bboxes = np.zeros((S, N, 4), np.float32)
    for s in range(S):
        for k in range(N):
            y0, x0 = rng.randint(0, H - 20), rng.randint(0, W - 20)
            hh, ww = rng.randint(5, 60, 2)
            masks[s, k, y0:y0 + hh, x0:x0 + ww] = 1
            bboxes[s, k] = [x0, y0, ww, hh]
    pidx, _ = JP.all_pair_indices(N)
    rois = np.array(jax.vmap(lambda b: JP.pair_rois(b, jnp.asarray(pidx)))(
        jnp.asarray(bboxes)))
    return images, masks, pidx, rois


def _split(a):
    hi = a.astype(jnp.bfloat16).astype(jnp.float32)
    return hi, (a - hi).astype(jnp.bfloat16).astype(jnp.float32)


def _tpu_dot(eq, a, b, precision):
    """The TPU's matmul precisions written out in f32 einsums:
    'highest' f32, 'high' the three bf16 products hi.hi + hi.lo + lo.hi,
    'default' one bf16 product."""
    dot = lambda x, y: jnp.einsum(eq, x, y,
                                  precision=jax.lax.Precision.HIGHEST)
    if precision == 'highest':
        return dot(a, b)
    (ah, al), (bh, bl) = _split(a), _split(b)
    if precision == 'default':
        return dot(ah, bh)
    return dot(ah, bh) + dot(ah, bl) + dot(al, bh)


@functools.partial(jax.jit, static_argnames=('precision', 'stage1_bf16'))
def _jax_ref(image, masks, pidx, rois, precision, stage1_bf16):
    """One scene's pair batch, build_pair_batch_matmul's algorithm with
    the RGB matmuls at a TPU precision (`_tpu_dot`)."""
    H, W = image.shape[:2]
    wy = jax.vmap(lambda r: JP._interp_matrix(r[1], r[3], OUT, H))(rois)
    wx = jax.vmap(lambda r: JP._interp_matrix(r[0], r[2], OUT, W))(rois)
    stage1 = _tpu_dot('pjw,hwc->phjc', wx, image, precision)
    if stage1_bf16:
        stage1 = stage1.astype(jnp.bfloat16).astype(jnp.float32)
    rgb = _tpu_dot('pih,phjc->pijc', wy, stage1, precision)
    rgb = jnp.clip(jnp.round(rgb), 0.0, 255.0)
    rgb = (rgb / 255.0 - JP.IMAGENET_MEAN) / JP.IMAGENET_STD
    m = JP._mask_pair_batch(masks, pidx, rois, OUT).astype(jnp.float32)
    return jnp.concatenate([m[:, 0, ..., None], m[:, 1, ..., None], rgb],
                           axis=-1)


def _assert_prep_close(got, want):
    np.testing.assert_array_equal(got[..., :2], want[..., :2])
    d = np.abs(got[..., 2:] - want[..., 2:])
    assert d.max() <= LSB, d.max()
    assert (d > 1e-5).mean() < 0.01, (d > 1e-5).mean()


def _port(images, masks, pidx, rois, precision, stage1_dtype=None):
    return TP.build_pair_batches_matmul(
        torch.from_numpy(images), torch.from_numpy(masks), pidx,
        torch.from_numpy(rois), out_size=OUT, precision=precision,
        stage1_dtype=stage1_dtype).numpy()


def test_einsum_prep_highest_matches_jax():
    images, masks, pidx, rois = _scenes(1)
    got = _port(images, masks, pidx, rois, 'highest')
    want = np.concatenate([np.asarray(JP.build_pair_batch_matmul(
        jnp.asarray(images[s]), jnp.asarray(masks[s]), jnp.asarray(pidx),
        jnp.asarray(rois[s]), out_size=OUT,
        precision=jax.lax.Precision.HIGHEST)) for s in range(2)])
    _assert_prep_close(got, want)


@pytest.mark.parametrize('precision,stage1_bf16', [
    ('high', False), ('default', False), ('highest', True), ('high', True),
    ('default', True)])
def test_einsum_prep_precisions_match_tpu_reference(precision, stage1_bf16):
    images, masks, pidx, rois = _scenes(2)
    got = _port(images, masks, pidx, rois, precision,
                torch.bfloat16 if stage1_bf16 else None)
    want = np.concatenate([np.asarray(_jax_ref(
        jnp.asarray(images[s]), jnp.asarray(masks[s]), jnp.asarray(pidx),
        jnp.asarray(rois[s]), precision, stage1_bf16)) for s in range(2)])
    _assert_prep_close(got, want)
    if precision == 'default' or stage1_bf16:
        # the knob is live: it moves RGB values against f32
        f32 = _port(images, masks, pidx, rois, 'highest')
        assert (np.abs(got - f32) > 1e-5).any()


def test_einsum_prep_refuses_unknown_precision():
    images, masks, pidx, rois = _scenes(3)
    with pytest.raises(ValueError, match='precision'):
        _port(images, masks, pidx, rois, 'low')


def _spy_wrappers(monkeypatch):
    """Count every call of a model kernel wrapper (bf16, v2 and int8c
    blocks, both stems) and of the 5-channel prep."""
    calls = {}

    def spy(mod, name):
        orig = getattr(mod, name)

        def f(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return orig(*a, **kw)
        monkeypatch.setattr(mod, name, f)

    for mod in (bk16, bk, ik):
        for name in dir(mod):
            if name.startswith('fused_') and not name.endswith('_plain') \
                    and hasattr(getattr(mod, name), 'launches'):
                spy(mod, name)
    spy(TF, 'fused_stem')
    spy(TQ, 'fused_stem')
    spy(TQ, 'fused_stem_int8')
    spy(PK, 'fused_prep_pairs')
    return calls


@pytest.mark.parametrize('profile,dtype', [
    ('serving-d1', 'int8'), ('serving-d2', 'int8c'), ('parity', 'bf16')])
def test_no_pallas_runs_no_model_kernel(monkeypatch, profile, dtype):
    calls = _spy_wrappers(monkeypatch)
    images, masks, bboxes = serving.synthetic_scenes(1, 120, 160, 3, seed=0)
    sc = serving.upload_scenes(images, masks, bboxes, device='cpu')
    pidx = torch.as_tensor(JP.all_pair_indices(3)[0])
    # the same step twice: with the dtype's default kernels, then with
    # --no-pallas (pallas5 prep on both, as the profile's prep is kept)
    for no_pallas in (False, True):
        argv = ['--profile', profile, '--dtype', dtype, '--prep-rgb',
                'pallas5'] + (['--no-pallas'] if no_pallas else [])
        args = tbench.build_parser().parse_args(argv)
        step = tbench.build_step(args, sc, pidx, OUT, torch.device('cpu'))
        calls.clear()
        logits, ij, _ = step()
        model = {k: n for k, n in calls.items() if k != 'fused_prep_pairs'}
        assert calls.get('fused_prep_pairs') == 1, calls
        if no_pallas:
            assert model == {}, model
        else:
            assert sum(model.values()) > 0, calls
        outs = logits if isinstance(logits, tuple) else (logits,)
        assert all(torch.isfinite(o).all() for o in outs)
        assert ij.shape == (3,)


@pytest.mark.parametrize('module', ['bench.py', 'serving.py', 'trace.py'])
def test_no_tpu_baseline(module):
    """The TPU round's target, 10,000 pairs/s, is no denominator of the
    port's bench: neither 10000, 10,000, 10_000 nor 1e4 appears."""
    path = os.path.join(os.path.dirname(tbench.__file__), module)
    with open(path) as f:
        src = f.read()
    assert not re.search(r'(?<![\d.])(10[,_]?000(\.0*)?|1e4|1e\+04)(?![\d])',
                         src), module


def test_vs_baseline_divides_by_the_h100_rate():
    assert 0 < tbench.BASELINE_PAIRS_PER_S != 1e4
    assert f'{tbench.BASELINE_PAIRS_PER_S:,}' in tbench.__doc__
