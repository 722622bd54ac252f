"""The port's CUDA kernels against their plain versions on the card, at
small and ragged shapes (chip_smoke.py covers the serving shapes).

Needs an NVIDIA GPU and nvcc; skips elsewhere. This file imports no JAX,
so on a machine without it run it without the repo's conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Bars as in chip_smoke.py: prep masks exact and RGB within one uint8 LSB
on under 1% of pixels; bottleneck outputs within one int8 LSB on under
1% of elements (f32 sums in another order move rare round() ties)."""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture(scope='module')
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from instaorder_tpu_torch.device import resolve_device
    return resolve_device()


def _blk(rng, dev, cin, cm, cout, down):
    t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=dev).contiguous()
    p = [t(rng.randn(cin, cm) * 0.6 / np.sqrt(cin) / 40, torch.bfloat16),
         t(rng.randn(cm) * 0.2, torch.float32),
         t(rng.randn(3, 3, cm, cm) * 1.2 / np.sqrt(9 * cm), torch.bfloat16),
         t(rng.randn(cm) * 0.2, torch.float32),
         t(rng.randn(cm, cout) * 40 / np.sqrt(cm), torch.bfloat16),
         t(rng.randn(cout) * 5, torch.float32)]
    if down:
        p += [t(rng.randn(cin, cout) / np.sqrt(cin), torch.bfloat16),
              t(rng.randn(cout) * 5, torch.float32)]
    return p


def _close(got, want, bar=1):
    assert got.dtype == want.dtype and got.shape == want.shape
    d = (got.float() - want.float()).abs()
    assert float(d.max()) <= bar, float(d.max())
    assert float((d > 0).float().mean()) < 0.01


@pytest.mark.parametrize('n,hw,in_dt,out_int8', [
    (3, 7, torch.int8, True), (2, 10, torch.bfloat16, False),
    (1, 16, torch.int8, False)])
def test_identity_kernel_ragged(dev, n, hw, in_dt, out_int8):
    from instaorder_tpu_torch.ops import bottleneck_kernels as BK
    rng = np.random.RandomState(n)
    x = torch.as_tensor(rng.randint(0, 128, (n, hw, hw, 64)),
                        device=dev).to(in_dt)
    p = _blk(rng, dev, 64, 64, 64, False)
    _close(BK.fused_bottleneck_i8v2_identity(x, *p, 0.45, out_int8=out_int8),
           BK.fused_bottleneck_i8v2_identity_plain(x, *p, 0.45,
                                                   out_int8=out_int8))


@pytest.mark.parametrize('hw', [8, 9, 14])
def test_down_s2_kernel_ragged(dev, hw):
    from instaorder_tpu_torch.ops import bottleneck_kernels as BK
    rng = np.random.RandomState(hw)
    x = torch.as_tensor(rng.randint(0, 128, (3, hw, hw, 64)), device=dev,
                        dtype=torch.int8)
    p = _blk(rng, dev, 64, 64, 128, True)
    got = BK.fused_bottleneck_i8v2_down_s2(x, *p, out_int8=False)
    assert got.shape[1] == (hw + 1) // 2
    _close(got, BK.fused_bottleneck_i8v2_down_s2_plain(x, *p, out_int8=False))


def test_stage_kernel(dev):
    from instaorder_tpu_torch.ops import bottleneck_kernels as BK
    rng = np.random.RandomState(7)
    x = torch.as_tensor(rng.randint(0, 128, (2, 12, 12, 64)), device=dev,
                        dtype=torch.int8)
    down = _blk(rng, dev, 64, 64, 256, True)
    blocks = [_blk(rng, dev, 256, 64, 256, False) for _ in range(2)]
    before = BK.fused_bottleneck_i8v2_stage.launches
    got = BK.fused_bottleneck_i8v2_stage(x, down, blocks, [0.5, 0.7])
    assert BK.fused_bottleneck_i8v2_stage.launches == before + 1
    _close(got, BK.fused_bottleneck_i8v2_stage_plain(x, down, blocks,
                                                     [0.5, 0.7]), bar=3)


def test_kernel_wrappers_refuse_bad_inputs(dev):
    from instaorder_tpu_torch.ops import bottleneck_kernels as BK
    rng = np.random.RandomState(0)
    p = _blk(rng, dev, 64, 64, 64, False)
    x = torch.zeros((1, 8, 8, 64), dtype=torch.float32, device=dev)
    with pytest.raises(ValueError):
        BK.fused_bottleneck_i8v2_identity(x, *p, 0.5)
    p32 = [a.float() for a in p]
    with pytest.raises(ValueError):
        BK.fused_bottleneck_i8v2_identity(x.to(torch.int8), *p32, 0.5)


@pytest.mark.parametrize('passes', [1, 3])
def test_prep_kernel_odd_sizes(dev, passes):
    from instaorder_tpu_torch import serving
    from instaorder_tpu_torch.ops import pairs as P
    from instaorder_tpu_torch.ops import prep_kernels as PK
    images, masks, bboxes = serving.synthetic_scenes(2, 131, 203, 4, seed=3)
    sc = serving.upload_scenes(images, masks, bboxes, device=dev)
    pidx = torch.as_tensor(P.all_pair_indices(4)[0], device=dev)
    rois = P.pair_rois(sc[2], pidx).contiguous()
    rois[0, 0] = torch.tensor([-40.0, -30.0, 260.0, 260.0])  # off-image
    got = PK.fused_prep_pairs(sc[0], sc[1], pidx, rois, out_size=72,
                              passes=passes)
    want = PK.fused_prep_pairs_plain(sc[0], sc[1], pidx, rois, out_size=72,
                                     passes=passes)
    assert bool((got[..., :2] == want[..., :2]).all())
    d = (got[..., 2:].float() - want[..., 2:].float()).abs()
    assert float(d.max()) <= 0.03125 + 1e-6
    assert float((d > 0).float().mean()) < 0.01
