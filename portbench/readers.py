"""The arithmetic the per-layer readers share (metrics/<name>.py). Each
takes the records a run keeps (`rec`: the window's seconds, chips,
useful FLOPs and configuration, and with --trace 1 the reduced trace)
and returns a number, or None where the run holds nothing to read."""

from __future__ import annotations

from .yardstick import PEAK_FLOPS, trunk_bound_s


def step_mfu(rec):
    """The useful model FLOPs of the window over the window's seconds
    times the chips' peak at the configuration's precision, in %."""
    if rec.get('window_s', 0) <= 0 or not rec.get('useful_flops'):
        return None
    peak = PEAK_FLOPS[rec['config']['peak']] * rec['chips']
    return 100.0 * rec['useful_flops'] / (rec['window_s'] * peak)


def trunk_roofline(rec):
    """The trunk calls' least time (yardstick.trunk_bound_s at each call's
    batch) over the device time of every kernel launched inside them, in
    %."""
    tr = rec.get('trace')
    if not tr or not tr.get('trunk_batches') or tr['trunk_s'] <= 0:
        return None
    bound = sum(trunk_bound_s(rec['config'], b) for b in tr['trunk_batches'])
    return 100.0 * bound / tr['trunk_s']


def idle_share(rec):
    """The share of the traced stretch with nothing running on the device,
    in %."""
    tr = rec.get('trace')
    if not tr or tr['window_s'] <= 0 or tr['busy_s'] <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - tr['busy_s'] / tr['window_s'])


def pad_share(rec):
    """The padded pairs' share of the pairs the trunk calls received, in
    %."""
    tr = rec.get('trace')
    if not tr or not tr.get('trunk_batches') or not tr.get('valid_pairs'):
        return None
    got = sum(tr['trunk_batches'])
    return 100.0 * (got - sum(tr['valid_pairs'])) / got


def allreduce_ms(rec):
    """Device ms of the NCCL all-reduce a step without the ranks' waits
    for each other: each collective's shortest kernel time over the ranks
    (the last rank to arrive waits for none), summed over the traced
    steps, over their number."""
    tr = rec.get('trace')
    if not tr or not tr.get('steps') or not tr.get('nccl_least_s'):
        return None
    return 1e3 * tr['nccl_least_s'] / tr['steps']
