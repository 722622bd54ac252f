"""The port's v2 quantization and the whole serving-d1 slice against the
JAX package on the CPU, at the small test geometry of
tests/test_quantize.py (ResNet-50 widths, layers (2, 2, 1, 1), 64x64
inputs, f32 compute).

Bars: calibration scales and quantized weights equal to rtol 1e-5 (f32
sums in another order); the slice's logits within 2% of max |logit| of
JAX `apply_folded_v2` (boundary round() ties may flip one int8 LSB and
the head smooths that), decisions equal wherever the JAX probability is
more than 1e-2 from 0.5."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from instaorder_tpu.models import quantize as JQ
from instaorder_tpu.models import resnet as jresnet
from instaorder_tpu.models.folding import fold_resnet
from instaorder_tpu.ops import pairs as JP
from instaorder_tpu.ops import pallas_blocks

from instaorder_tpu_torch import convert, device, serving
from instaorder_tpu_torch.models import quantize as TQ
import torch_threads  # noqa: F401 (the suite's torch thread cap)

REPO = Path(__file__).resolve().parent.parent
OUT = 64


@pytest.fixture(scope='module')
def net():
    params, stats, cfg = jresnet.init(
        jax.random.PRNGKey(0), arch='resnet50', in_channels=5,
        num_classes=2, layers_override=(2, 2, 1, 1))
    folded = jax.device_get(fold_resnet(params, stats, cfg))
    rng = np.random.RandomState(0)
    xs = [rng.randn(2, 64, 64, 5).astype(np.float32) for _ in range(2)]
    return folded, cfg, xs


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def _assert_trees_close(got, want, rtol=1e-5):
    gl, wl = _leaves(got), _leaves(want)
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (p, g), (_, w) in zip(gl, wl):
        np.testing.assert_allclose(np.asarray(g, np.float32),
                                   np.asarray(w, np.float32), rtol=rtol,
                                   atol=0, err_msg=str(p))


def test_calibration_matches_jax(net, monkeypatch):
    folded, cfg, xs = net
    want = jax.device_get(JQ.calibrate_folded_resnet(folded, cfg, xs))
    tf = convert.to_torch(folded)
    got = TQ.calibrate_folded_resnet(tf, cfg,
                                     [torch.from_numpy(x) for x in xs])
    _assert_trees_close(got, want)
    # chunked calibration (absmax is chunk-associative)
    monkeypatch.setattr(TQ, 'CAL_CHUNK', 1)
    _assert_trees_close(TQ.calibrate_folded_resnet(
        tf, cfg, [torch.from_numpy(x) for x in xs]), want)


@pytest.mark.parametrize('cdt', ['f32', 'bf16'])
def test_quantize_folded_v2_matches_jax(net, cdt):
    folded, cfg, xs = net
    scales = jax.device_get(JQ.calibrate_folded_resnet(folded, cfg, xs))
    jdt = jnp.bfloat16 if cdt == 'bf16' else jnp.float32
    want = jax.device_get(JQ.quantize_folded_v2(folded, cfg, scales,
                                                compute_dtype=jdt))
    got = TQ.quantize_folded_v2(
        convert.to_torch(folded), cfg, convert.to_torch(scales),
        compute_dtype=torch.bfloat16 if cdt == 'bf16' else torch.float32)
    assert got['layer1'][0]['conv1']['w'].dtype == (
        torch.bfloat16 if cdt == 'bf16' else torch.float32)
    assert isinstance(got['layer1'][1]['r'], float)
    _assert_trees_close(convert.to_numpy(got), want)


def _scenes(seed=3, S=2, H=96, W=128, N=3):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 255, (S, H, W, 3)).astype(np.float32)
    masks = np.zeros((S, N, H, W), np.float32)
    bboxes = np.zeros((S, N, 4), np.float32)
    for s in range(S):
        for k in range(N):
            y0, x0 = rng.randint(0, H - 40), rng.randint(0, W - 40)
            hh, ww = rng.randint(15, 40, 2)
            masks[s, k, y0:y0 + hh, x0:x0 + ww] = 1
            bboxes[s, k] = [x0, y0, ww, hh]
    pidx, _ = JP.all_pair_indices(N)
    return images, masks, bboxes, pidx


def _interpret(monkeypatch):
    for n in ('fused_bottleneck_i8v2_hwnc', 'fused_bottleneck_i8v2_hwnc_stage',
              'fused_bottleneck_down_s2_i8v2_hwnc'):
        orig = getattr(pallas_blocks, n)
        monkeypatch.setattr(pallas_blocks, n,
                            (lambda o: lambda *a, **kw: o(
                                *a, **dict(kw, interpret=True)))(orig))


def test_serving_megastep_matches_jax(net, monkeypatch):
    folded, cfg, _ = net
    images, masks, bboxes, pidx = _scenes()
    pj = jnp.asarray(pidx)
    rois = jax.vmap(lambda b: JP.pair_rois(b, pj))(jnp.asarray(bboxes))
    x = JP.build_pair_batches_fused(
        jnp.asarray(images), jnp.asarray(masks), pj, rois, out_size=OUT,
        dtype=jnp.bfloat16, passes=1, fuse_masks=True, interpret=True)
    scales = JQ.calibrate_folded_resnet(folded, cfg,
                                        [np.asarray(x, np.float32)])
    qv2 = JQ.quantize_folded_v2(folded, cfg, scales,
                                compute_dtype=jnp.float32)
    want_xla = np.asarray(JQ.apply_folded_v2(qv2, cfg, x, use_pallas=False))
    _interpret(monkeypatch)
    want_pl = np.asarray(JQ.apply_folded_v2(qv2, cfg, x, use_pallas=True))

    q = convert.to_torch(jax.device_get(qv2))
    logits, ij, ji = serving.megastep(
        q, cfg, torch.from_numpy(images), torch.from_numpy(masks),
        torch.from_numpy(bboxes), pidx, out_size=OUT, passes=1)
    got = logits.numpy()
    for want in (want_xla, want_pl):
        scale = max(np.abs(want).max(), 1e-6)
        assert np.abs(got - want).max() / scale < 0.02, \
            np.abs(got - want).max() / scale
        p = 1.0 / (1.0 + np.exp(-want))
        for col, dec in ((1, ij.numpy()), (0, ji.numpy())):
            sure = np.abs(p[:, col] - 0.5) > 1e-2
            np.testing.assert_array_equal(dec[sure], p[sure, col] > 0.5)


def test_build_serving_model_runs_on_cpu():
    images, masks, bboxes, pidx = _scenes(seed=4)
    sc = serving.upload_scenes(images, masks, bboxes, device='cpu')
    x = serving.prep_pairs(*sc, pidx, out_size=OUT)
    q, cfg = serving.build_serving_model(0, x, device='cpu',
                                         weight_init='kaiming_out')
    logits, ij, ji = serving.megastep(q, cfg, *sc, pidx, out_size=OUT)
    assert logits.shape == (6, 2) and torch.isfinite(logits).all()
    assert ij.dtype == torch.bool and ji.shape == (6,)


def test_entry_points_refuse_missing_cuda(monkeypatch):
    """No GPU and no explicit device='cpu': the entry points raise
    instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    images, masks, bboxes, _ = _scenes()
    with pytest.raises(RuntimeError, match='CUDA'):
        device.resolve_device()
    with pytest.raises(RuntimeError, match='CUDA'):
        serving.upload_scenes(images, masks, bboxes)
    with pytest.raises(RuntimeError, match='CUDA'):
        serving.build_serving_model(0, torch.zeros(1, 64, 64, 5))
    assert device.resolve_device('cpu').type == 'cpu'


def test_port_imports_without_jax():
    """Every port module and chip_smoke.py import with jax blocked, and
    no source file of the port names the JAX package."""
    pkg = REPO / 'instaorder_tpu_torch'
    mods = sorted('instaorder_tpu_torch.' + '.'.join(
        p.relative_to(pkg).with_suffix('').parts)
        for p in pkg.rglob('*.py'))
    mods = [m[:-len('.__init__')] if m.endswith('.__init__') else m
            for m in mods]
    for m in ('ops.bottleneck_bf16_kernels', 'ops.stem_kernels',
              'ops.int8_kernels',
              'ops.prep_kernels', 'models.folding', 'models.quantize',
              'serving', 'bench', 'trace', 'train.trainer', 'train.step',
              'train.algos', 'train.optim', 'losses', 'core.schedule',
              'data.datasets', 'data.loader', 'data.sampler',
              'cli.train', 'models.midas', 'eval.disp', 'utils.midas_io',
              'cli.test_disp', 'models.legacy', 'ops.crf',
              'utils.visualize', 'utils.profiling'):
        assert 'instaorder_tpu_torch.' + m in mods, m
    code = ('import sys; sys.modules["jax"] = None; '
            'sys.modules["instaorder_tpu"] = None; import importlib\n'
            f'for m in {mods!r}: importlib.import_module(m)\n'
            'import chip_smoke\n'
            # the grain path: mode='grain' imports grain.python, which
            # itself tries jax
            'from instaorder_tpu_torch.data.loader import DataLoader\n'
            'assert list(DataLoader(None, [], 1, mode="grain")) == []\n'
            'assert "grain.python" in sys.modules\n'
            'bad = [m for m in sys.modules if m == "jax" and sys.modules[m] '
            'is not None or m.startswith("jax.")]\n'
            'assert not bad, bad\n')
    res = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    for f in list(pkg.rglob('*.py')) + list(pkg.rglob('*.cu')) + [
            REPO / 'chip_smoke.py']:
        assert 'instaorder_tpu.' not in f.read_text(), f
