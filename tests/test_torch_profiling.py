"""The port's utils/profiling.py against the JAX package's on the CPU, and
utils/__init__'s re-exports.

  * resnet50_flops equal to JAX's at several input sizes and channel
    counts; pairs_per_sec_mfu equal to JAX's at the same peak, and its
    default peak the H100's dense bf16 989 TFLOP/s (not JAX's TPU 197);
  * StepTimer: the window, the mean, stop() with a nested result (on
    the CPU there is no stream to wait for);
  * trace(dir) writes a Chrome trace holding the block's ops;
  * `instaorder_tpu_torch.utils` exports JAX's geometry names, each the
    port's utils.geometry function.
"""

import json
import time

import pytest
import torch

import instaorder_tpu.utils as JU
from instaorder_tpu.utils import profiling as JP

import instaorder_tpu_torch.utils as TU
from instaorder_tpu_torch.utils import geometry as TG
from instaorder_tpu_torch.utils import profiling as TP
import torch_threads  # noqa: F401 (the suite's torch thread cap)


@pytest.mark.parametrize('h,w,c', [(224, 224, 3), (256, 256, 5),
                                   (384, 512, 5), (97, 131, 4)])
def test_flops_match_jax(h, w, c):
    assert TP.resnet50_flops(h, w, c) == JP.resnet50_flops(h, w, c)


def test_mfu_matches_jax():
    for pps, size in ((1000.0, 256), (123.4, 384)):
        assert TP.pairs_per_sec_mfu(pps, size, peak_tflops=197.0) == \
            JP.pairs_per_sec_mfu(pps, size, peak_tflops=197.0)
        assert TP.pairs_per_sec_mfu(pps, size) == pytest.approx(
            pps * 2 * TP.resnet50_flops(size, size) / 989e12, rel=1e-15)
    assert TP.H100_BF16_PEAK_TFLOPS == 989.0


def test_step_timer():
    t = TP.StepTimer(window=3)
    for k in range(5):
        t.start()
        time.sleep(0.002)
        dt = t.stop({'a': [torch.ones(2)], 'b': (torch.zeros(1), None)})
        assert dt >= 0.002
    assert len(t.times) == 3 and t.avg == sum(t.times) / 3
    assert TP.StepTimer().avg == 0.0


def test_trace_writes_chrome_trace(tmp_path):
    with TP.trace(str(tmp_path / 't')):
        torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    with open(tmp_path / 't' / 'trace.json') as f:
        events = json.load(f)['traceEvents']
    assert any('mm' in str(e.get('name', '')) for e in events)


def test_utils_reexports_geometry():
    names = [n for n in dir(JU) if not n.startswith('_')
             and n not in ('geometry', 'midas_io', 'profiling', 'telemetry',
                           'visualize')]
    assert names
    for n in names:
        assert getattr(TU, n) is getattr(TG, n), n
