"""Learning-rate schedule: piecewise-linear warmup + step decay
(counterpart of instaorder_tpu/core/schedule.py's `step_lr`).

The reference's StepLRScheduler (utils/scheduler.py:58-109): optionally
several linear warmup segments (warmup_steps[i] -> warmup_lr[i]), then
step decay at `milestones` with cumulative `lr_mults`. The Trainer calls
it on the host each iteration with the explicit step index (reference
trainer.py:161), so a resume is exact, and hands the float to the train
step. The JAX package's `step_lr_jnp` (the same schedule traced inside
a compiled step) has no counterpart: nothing in the port's train step
needs the schedule on the device.
"""

from __future__ import annotations

from bisect import bisect_right
from typing import Sequence


def step_lr(base_lr: float,
            milestones: Sequence[int],
            lr_mults: Sequence[float],
            warmup_lr: Sequence[float] = (),
            warmup_steps: Sequence[int] = ()):
    """Returns lr(step) -> float with the reference's StepLRScheduler
    semantics."""
    milestones = list(milestones)
    lr_mults = list(lr_mults)
    warmup_lr = list(warmup_lr)
    warmup_steps = list(warmup_steps)
    if len(milestones) != len(lr_mults):
        raise ValueError('lr_steps and lr_mults differ in length')
    if milestones != sorted(milestones):
        raise ValueError(f'lr_steps not sorted: {milestones}')
    if len(warmup_lr) != len(warmup_steps):
        raise ValueError('warmup_lr and warmup_steps differ in length')
    mults_cum = [1.0]
    for m in lr_mults:
        mults_cum.append(mults_cum[-1] * m)

    def lr(step: int) -> float:
        pos = bisect_right(warmup_steps, step)
        if pos < len(warmup_steps):
            if pos == 0:
                cur = base_lr + step * (warmup_lr[0] - base_lr) / \
                    warmup_steps[0]
            else:
                span = warmup_steps[pos] - warmup_steps[pos - 1]
                cur = warmup_lr[pos - 1] + (step - warmup_steps[pos - 1]) * (
                    warmup_lr[pos] - warmup_lr[pos - 1]) / span
            return float(cur)
        pos = bisect_right(milestones, step)
        if not warmup_lr:
            return float(base_lr * mults_cum[pos])
        return float(warmup_lr[-1] * mults_cum[pos])

    return lr
