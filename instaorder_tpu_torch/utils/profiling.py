"""Tracing and step timing (counterpart of instaorder_tpu/utils/profiling.py).

- `trace(dir)`: a `torch.profiler` capture of the block (CPU and, where
  CUDA is available, the card's kernels), written into `dir` as a Chrome
  trace (`trace.json`, viewable in Perfetto or chrome://tracing).
- `StepTimer`: wall-clock per-step timing; `stop(result)` first waits
  for the CUDA stream of every tensor in `result`, so the time covers
  the device work the step queued; the mean over a window of steps.
- `resnet50_flops` / `pairs_per_sec_mfu`: the analytic cost of the
  siamese pair pipeline, for model-FLOP utilisation in bench logs.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

# the H100 SXM's dense bf16 tensor-core peak (989 TFLOP/s, NVIDIA's data
# sheet; the card the port targets)
H100_BF16_PEAK_TFLOPS = 989.0


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block into `log_dir`/trace.json (Chrome trace)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, 'trace.json'))


def _sync(result):
    """Wait for the CUDA stream of every tensor in a nested result."""
    if isinstance(result, torch.Tensor):
        if result.is_cuda:
            torch.cuda.current_stream(result.device).synchronize()
    elif isinstance(result, dict):
        for v in result.values():
            _sync(v)
    elif isinstance(result, (list, tuple)):
        for v in result:
            _sync(v)


class StepTimer:
    def __init__(self, window=20):
        self.window = window
        self.times = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, result=None):
        if result is not None:
            _sync(result)
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        if len(self.times) > self.window:
            del self.times[0]
        return dt

    @property
    def avg(self):
        return sum(self.times) / max(len(self.times), 1)


def resnet50_flops(h, w, in_channels=5):
    """Approximate forward FLOPs of ResNet-50 at an (h, w) input (2 x
    MACs): 4.1 GFLOP at 3 x 224^2, scaled by the pixels, plus the stem's
    extra input channels."""
    base_224 = 4.1e9
    scale = (h * w) / (224 * 224)
    stem_extra = 2 * (h // 2) * (w // 2) * 64 * 49 * (in_channels - 3)
    return base_224 * scale + stem_extra


def pairs_per_sec_mfu(pairs_per_sec, input_size=256,
                      peak_tflops=H100_BF16_PEAK_TFLOPS):
    """Model-FLOP utilisation of the siamese pair pipeline (two forwards
    a pair) at a measured throughput; peak_tflops defaults to the H100
    SXM's dense bf16 peak."""
    flops_per_pair = 2 * resnet50_flops(input_size, input_size)
    return pairs_per_sec * flops_per_pair / (peak_tflops * 1e12)
