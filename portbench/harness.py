"""What every cell shares: the specs read by name, the set-up clock, the
profiler's trace reduced to the records the per-layer readers take, the
checks and the result line.

A cell is found by its name in BENCHMARK.json; its configuration,
traffic mix and limits are the files `configs/<config>.json`,
`traffic/<traffic>.json` and `limits/<workload>.json` beside this file;
the mix names its driver (`drivers/<driver>.py`, whose `run(ctx)` runs
set-up, the window, the traced stretch and the check, and whose
`readings(ctx, seeds, controls)` reads the numbers the limits are set
from, for `readings.py`); each per-layer metric is
read by `metrics/<name>.py`'s `read(rec)`, which returns None where the
run holds nothing for it.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'instaorder_tpu')


def process_start():
    """The wall-clock time this process started (from /proc), or now."""
    try:
        with open('/proc/self/stat') as f:
            ticks = int(f.read().rsplit(')', 1)[1].split()[19])
        with open('/proc/uptime') as f:
            up = float(f.read().split()[0])
        return time.time() - up + ticks / os.sysconf('SC_CLK_TCK')
    except (OSError, ValueError, IndexError):
        return time.time()


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark():
    return load_json(HERE.parent / 'BENCHMARK.json')


def cell(bench, workload):
    """(workload entry, config, mix, limits) of a cell, by name."""
    wl = {w['name']: w for w in bench['workloads']}[workload]
    conf = {c['name']: c for c in bench['configs']}[wl['config']]
    config = load_json(HERE.parent / conf['file'])
    mix = load_json(HERE / 'traffic' / f"{wl['traffic']}.json")
    limits = load_json(HERE / 'limits' / f'{workload}.json')
    return wl, config, mix, limits


def cell_metrics(bench, workload, kind):
    """The `kind` ('end_to_end' or 'per_layer') metrics a cell reports."""
    return [m for m in bench[kind]
            if 'workloads' not in m or workload in m['workloads']]


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name):
    """The module `drivers/<name>.py` (its `run(ctx)`)."""
    return importlib.import_module(f'portbench.drivers.{name}')


def reader(metric):
    """The module `metrics/<metric>.py` (its `read(rec)`)."""
    return load_module(HERE / 'metrics' / f'{metric}.py',
                       f'portbench_metric_{metric.replace(".", "_")}')


def plant(ctx, rank=0):
    """Apply ctx['plant'] ('module:function', the fault tests' planted
    fault) in this process; nothing in a benchmark run."""
    if ctx.get('plant'):
        mod, fn = ctx['plant'].split(':')
        getattr(importlib.import_module(mod), fn)(rank)


def per_seed(ctx, seeds, controls, one):
    """A one-process driver's readings: `one(ctx, control)` on each seed
    (control on those in `controls`), one JSON line printed a seed; ->
    the lines. ctx['plant'], where set, is planted once first."""
    import torch
    plant(ctx)
    lines = []
    for seed in seeds:
        t = time.time()
        r = dict(one(dict(ctx, seed=seed), seed in controls), seed=seed,
                 seconds=time.time() - t)
        lines.append(r)
        print(json.dumps(r), flush=True)
        if ctx['device'].type == 'cuda':
            torch.cuda.empty_cache()
    return lines


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split('.')[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


# ---------------------------------------------------------------------------
# the traced stretch
# ---------------------------------------------------------------------------

TRUNK = 'portbench.trunk'
WINDOW = 'portbench.window'
MARK = 'lerp'


def _union(iv):
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_trace(prof):
    """A profiled stretch -> records: window_s (the WINDOW range on the
    host clock), busy_s (the union of device activity in it),
    device_ops [[name, s]] (top 10 by time), idle_gaps [[host op, s]]
    (the 10 longest gaps, each named by the innermost host op running
    at its middle), trunk_s (device time of the kernels between each
    pair of `traced` markers) and nccl_kernels (the device time of each
    NCCL kernel wholly inside the window, in launch order)."""
    from torch.autograd import DeviceType
    evs = list(prof.events())
    win = [e for e in evs if e.name == WINDOW]
    if not win:
        return None
    w0 = min(e.time_range.start for e in win)
    w1 = max(e.time_range.end for e in win)
    # device activity: kernels, copies, sets (not the device-side
    # annotations of host ranges, such as NCCL's 'nccl:all_reduce')
    dev = [e for e in evs if e.device_type != DeviceType.CPU
           and not getattr(e, 'is_user_annotation', False)
           and not e.name.startswith(('portbench.', 'nccl:'))
           and e.time_range.end > w0 and e.time_range.start < w1]
    host = [e for e in evs if e.device_type == DeviceType.CPU
            and e.name not in (WINDOW, TRUNK)]
    busy = _union([(max(e.time_range.start, w0), min(e.time_range.end, w1))
                   for e in dev])
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    gaps, t = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    named = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = (s + e) / 2
        cover = [h for h in host
                 if h.time_range.start <= mid <= h.time_range.end]
        who = (min(cover, key=lambda h: h.time_range.elapsed_us()).name
               if cover else 'host: no op')
        named.append([who[:160], (e - s) * 1e-6])
    marks = sorted((e for e in dev if MARK in e.name),
                   key=lambda e: e.time_range.start)
    trunk = 0.0
    for a, b in zip(marks[0::2], marks[1::2]):
        trunk += sum(e.time_range.elapsed_us() for e in dev
                     if MARK not in e.name
                     and e.time_range.start >= a.time_range.end
                     and e.time_range.end <= b.time_range.start)
    nccl = [e.time_range.elapsed_us()
            for e in sorted(dev, key=lambda e: e.time_range.start)
            if 'nccl' in e.name.lower()
            and w0 <= e.time_range.start and e.time_range.end <= w1]
    return {'window_s': (w1 - w0) * 1e-6,
            'busy_s': sum(e - s for s, e in busy) * 1e-6,
            'device_ops': [[k[:160], v * 1e-6] for k, v in sorted(
                by_name.items(), key=lambda kv: -kv[1])[:10]],
            'idle_gaps': named,
            'trunk_s': trunk * 1e-6,
            'nccl_kernels': [t * 1e-6 for t in nccl]}


def profiler(device):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == 'cuda':
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def traced(fn, device):
    """fn wrapped for the traced stretch: a profiler range around it and a
    marker kernel (a one-element lerp, an op no model here runs) before
    and after it on the stream, so that the kernels between two markers
    are the ones the call launched, whatever launched them (a range alone
    misses the kernels launched through ctypes). The marker runs once
    here, before any profiling."""
    import torch
    t = torch.ones(3, device=device)

    def mark():
        torch.lerp(t[:1], t[1:2], t[2:])
    mark()

    def wrapped(*a, **k):
        with torch.profiler.record_function(TRUNK):
            mark()
            out = fn(*a, **k)
            mark()
        return out
    return wrapped


# ---------------------------------------------------------------------------
# checks and the result line
# ---------------------------------------------------------------------------

def check(name, value, limit):
    """One compared number: it passes where value <= limit."""
    value = float(value)
    return {'name': name, 'value': value, 'limit': float(limit),
            'ok': bool(value <= limit)}


def result_line(bench, workload, trace, out, setup_s):
    """The result object of a run from the driver's output `out`."""
    metrics = {}
    if trace:
        for m in cell_metrics(bench, workload, 'per_layer'):
            v = reader(m['name']).read(out['records'])
            if v is not None:
                metrics[m['name']] = {'value': float(v), 'unit': m['unit']}
    else:
        vals = dict(out['end_to_end'], setup_s=setup_s)
        for m in cell_metrics(bench, workload, 'end_to_end'):
            if m['name'] in vals:
                metrics[m['name']] = {'value': float(vals[m['name']]),
                                      'unit': m['unit']}
    checks = out['checks']
    res = {'correct': bool(checks) and all(c['ok'] for c in checks)
           and out['failed'] == 0,
           'attempted': int(out['attempted']), 'failed': int(out['failed']),
           'metrics': metrics, 'device': out['device']}
    tr = out['records'].get('trace')
    if trace and tr:
        res['device']['busy_s'] = tr['busy_s']
        res['device']['window_s'] = tr['window_s']
        res['breakdown'] = {'device_ops': tr['device_ops'],
                            'idle_gaps': tr['idle_gaps']}
    res['checks'] = {c['name']: {'value': c['value'], 'limit': c['limit']}
                     for c in checks}
    return res


def device_info(device, count, peak):
    """The result line's `device` object."""
    import torch
    if device.type == 'cuda':
        return {'platform': 'gpu', 'kind': torch.cuda.get_device_name(device),
                'count': count, 'memory_peak_bytes': int(peak)}
    return {'platform': 'cpu', 'kind': 'cpu', 'count': count,
            'memory_peak_bytes': int(peak)}
