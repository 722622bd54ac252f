"""Offline ordering of a dataset: the serving megastep in a closed loop.

Set-up: the seeded weights (heads centred on the reference's features
of one scene's pairs), a pool of step batches of scenes on the device,
and the program's model built as `serving.build_serving_model` builds
it, from these weights: BN folded (`folding.fold_resnet`), calibrated
on the first batch's prepped pairs (`quantize.calibrate_folded_resnet`),
quantized (`quantize.quantize_folded_v2`), the stem kernel's weights
added on the card. A few warm-up steps.

Window: `serving.megastep` dispatched back to back over the pool; the
window ends in a synchronize. The traced run then profiles a few more
steps, the trunk (`quantize._apply_trunk_v2`) inside a range.

Check: a sample of the window's pairs, drawn from the seed, against the
reference's v2 model worked out again from the same weights and scenes
(prep, folding, calibration, quantization, forward).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import harness, traffic, weights, yardstick
from ..reference import model as R
from ..reference import prep as RP


def port_cfg(config):
    """The port's static config dict of the configuration's ResNet-50."""
    dual = isinstance(config['num_classes'], list)
    return {'arch': 'resnet50', 'block': 'bottleneck',
            'layers': tuple(config['layers']), 'groups': 1,
            'base_width': 64, 'feat_dim': 2048, 'dual_head': dual}


def reference_scene_batch(sc, s, pairs, out, idx=None):
    """The reference's pair batch of scene s (all pairs, or rows idx)."""
    images, masks, bboxes = sc
    pairs = pairs if idx is None else pairs[idx]
    rois = RP.pair_rois(bboxes[s], pairs)
    return RP.pair_batch(images[s], masks[s], pairs, rois, out)


def build(ctx, params, stats, calib_x, dtype='int8'):
    """The program's model from the harness's weights: v2 ('int8'), or
    the int8c model (the control's lower precision)."""
    from instaorder_tpu_torch.models import folding
    from instaorder_tpu_torch.models import quantize as Q
    cfg = port_cfg(ctx['config'])
    folded = folding.fold_resnet(params, stats, cfg)
    scales = Q.calibrate_folded_resnet(folded, cfg, [calib_x.float()])
    if dtype == 'int8c':
        q = Q.quantize_folded_resnet(folded, cfg, scales)
        if ctx['device'].type == 'cuda':
            Q.add_kernel_weights(q)
    else:
        q = Q.quantize_folded_v2(folded, cfg, scales)
        if ctx['device'].type == 'cuda':
            folding.add_stem_kernel_weights(q['conv1'])
    return q, cfg


def setup(ctx, dtype='int8'):
    """The pool of step batches, the seeded weights and the program's
    model ('int8': v2; 'int8c': the control) behind a `step(b)`."""
    from instaorder_tpu_torch import serving
    from instaorder_tpu_torch.ops.pairs import all_pair_indices
    dev, config, mix, seed = ctx['device'], ctx['config'], ctx['mix'], ctx['seed']
    S = mix['scenes_per_step']
    pool = [traffic.scenes(seed, 10 + k, S, mix, dev)
            for k in range(mix['pool_steps'])]
    pairs = all_pair_indices(mix['instances'])[0]
    pidx = torch.as_tensor(pairs, dtype=torch.int32, device=dev)
    params, stats = weights.make_trunk(seed, dev, config['in_channels'],
                                       config['bn3_gain'])
    xc = reference_scene_batch(pool[0], 0, pairs, config['input_size'])
    feats = R.forward_folded(R.fold(params, stats), xc.to(torch.bfloat16)
                             .float(), features=True)
    weights.centred_heads(params, seed, config['num_classes'], feats)
    prep = dict(out_size=config['input_size'], passes=config['prep_passes'],
                prep_rgb=config['prep'], prep_precision=config['prep_precision'])
    calib_x = serving.prep_pairs(*pool[0], pidx, **prep)
    q, cfg = build(ctx, params, stats, calib_x, dtype)
    del calib_x
    kw = dict(prep, directions=config['directions'], use_pallas=True)

    def step(b):
        return serving.megastep(q, cfg, *pool[b], pidx, **kw)
    return {'step': step, 'pool': pool, 'pairs': pairs, 'params': params,
            'stats': stats, 'pairs_per_step': S * len(pairs)}


def window(st, seconds, sync):
    """Steps back to back over the pool for `seconds`; -> (outputs, s)."""
    outs, k = [], 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        b = k % len(st['pool'])
        outs.append((b, *st['step'](b)))
        k += 1
    sync()
    return outs, time.perf_counter() - t0


def reference_model(ctx, st):
    """The reference's v2 model: folded, calibrated on its own prep of the
    first step batch, quantized."""
    out = ctx['config']['input_size']
    folded = R.fold(st['params'], st['stats'])
    cal = torch.cat([reference_scene_batch(st['pool'][0], s, st['pairs'],
                                           out).to(torch.bfloat16)
                     for s in range(ctx['mix']['scenes_per_step'])])
    return R.quantize_v2(folded, R.calibrate_v2(folded, cal))


def reference_logits(ctx, st, want):
    """The reference v2 model's logits for `want`: {(b, scene, pair)}."""
    out = ctx['config']['input_size']
    q = reference_model(ctx, st)
    by, keys, xs = {}, [], []
    for b, s, p in sorted(want):
        by.setdefault((b, s), []).append(p)
    for (b, s), ps in by.items():
        xs.append(reference_scene_batch(st['pool'][b], s, st['pairs'], out,
                                        np.array(ps)).to(torch.bfloat16))
        keys += [(b, s, p) for p in ps]
    x = torch.cat(xs)
    lg = torch.cat([R.forward_v2(q, x[i:i + 128])
                    for i in range(0, len(keys), 128)])
    return dict(zip(keys, lg))


def compare(ctx, st, outs):
    """The checks of a window's outputs: every step's answers present and
    finite; on a seeded sample of its pairs, the widest and the mean gap
    between the program's and the reference's logits over the spread of
    the reference's, and every decision the reference makes beyond the
    widest gap allowed."""
    limits, mix = ctx['limits'], ctx['mix']
    n = st['pairs_per_step']
    P = len(st['pairs'])
    bad = sum(1 for _b, lg, i_j, j_i in outs
              if lg.shape != (n, 2) or i_j.shape != (n,) or j_i.shape != (n,)
              or not bool(torch.isfinite(lg).all()))
    rng = np.random.default_rng(weights.subseed(ctx['seed'], 7))
    k = min(mix['check_pairs'], len(outs) * n)
    pick = rng.choice(len(outs) * n, size=k, replace=False)
    want = {(outs[i // n][0], (i % n) // P, (i % n) % P) for i in pick}
    ref = reference_logits(ctx, st, want)
    lp, lr, dp = [], [], []
    for i in pick:
        b, lg, i_j, j_i = outs[i // n]
        r = i % n
        if lg.shape != (n, 2):
            continue
        lp.append(lg[r].float())
        lr.append(ref[(b, r // P, r % P)].float())
        dp.append(torch.stack([j_i[r], i_j[r]]))
    if not lp:
        inf = float('inf')
        return [harness.check('answers_missing', bad, 0),
                harness.check('logit_gap', inf, limits['logit_gap']),
                harness.check('logit_gap_mean', inf,
                              limits['logit_gap_mean'])], {'sampled': 0}
    lp, lr, dp = torch.stack(lp), torch.stack(lr), torch.stack(dp)
    scale = lr.std()
    d = (lp - lr).abs() / scale
    gap, mean = d.max().item(), d.mean().item()
    sure = (lr.abs() > limits['logit_gap'] * scale)
    flips = ((dp != (lr > 0)) & sure).sum().item()
    return [harness.check('answers_missing', bad, 0),
            harness.check('logit_gap', gap, limits['logit_gap']),
            harness.check('logit_gap_mean', mean, limits['logit_gap_mean']),
            harness.check('sure_flips', flips, 0)], {
        'sampled': len(pick), 'sure': int(sure.sum()), 'scale': float(scale)}


def run(ctx):
    """One run of the cell: set-up, the window, with ctx['trace'] the
    traced stretch, then the check. Returns what `harness.result_line`
    reads: t_window, attempted, failed, end_to_end, records, checks,
    info, device."""
    dev = ctx['device']
    harness.plant(ctx)
    sync = torch.cuda.synchronize if dev.type == 'cuda' else (lambda: None)
    st = setup(ctx)
    for k in range(ctx['mix']['warm_steps']):
        st['step'](k % len(st['pool']))
    sync()
    t_window = time.time()
    outs, secs = window(st, ctx['seconds'], sync)
    pairs = len(outs) * st['pairs_per_step']
    rec = {'chips': 1, 'window_s': secs, 'config': ctx['config'],
           'useful_flops': pairs * yardstick.forward_flops(ctx['config'])
           * ctx['config']['directions']}
    if ctx['trace']:
        rec['trace'] = trace(ctx, st, sync)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == 'cuda' else 0
    st['step'] = None
    if dev.type == 'cuda':
        torch.cuda.empty_cache()
    checks, info = compare(ctx, st, outs)
    return {'t_window': t_window, 'attempted': pairs, 'failed': 0,
            'end_to_end': {'pairs_per_s': pairs / secs},
            'records': rec, 'checks': checks, 'info': info,
            'device': harness.device_info(dev, 1, peak)}


def trace(ctx, st, sync):
    """A few steps under the profiler, the trunk inside a range; ->
    the reduced trace with the trunk calls' batch sizes."""
    from instaorder_tpu_torch.models import quantize as Q
    real = Q._apply_trunk_v2
    calls = []

    def trunk(q, cfg, h8, *a, **k):
        calls.append(int(h8.shape[0]))
        return real(q, cfg, h8, *a, **k)
    Q._apply_trunk_v2 = harness.traced(trunk, ctx['device'])
    try:
        with harness.profiler(ctx['device']) as prof:
            with torch.profiler.record_function(harness.WINDOW):
                for k in range(ctx['mix']['trace_steps']):
                    st['step'](k % len(st['pool']))
                sync()
    finally:
        Q._apply_trunk_v2 = real
    red = harness.reduce_trace(prof)
    if red is not None:
        red['trunk_batches'] = calls
    return red


def _reading(ctx, control):
    """The compared numbers of the program (the v2 model through the
    megastep over a short window) and, with `control`, of the control
    (the program's int8c model, int8 inside the blocks)."""
    sync = torch.cuda.synchronize if ctx['device'].type == 'cuda' \
        else (lambda: None)
    out = {}
    for name, dtype in [('program', 'int8')] + ([('control', 'int8c')]
                                                if control else []):
        st = setup(ctx, dtype)
        for k in range(ctx['mix']['warm_steps']):
            st['step'](k % len(st['pool']))
        outs, _ = window(st, ctx['seconds'], sync)
        st['step'] = None
        checks, info = compare(ctx, st, outs)
        out[name] = dict({c['name']: c['value'] for c in checks}, **info)
    return out


def readings(ctx, seeds, controls):
    """readings.py's lines: `_reading` on each seed."""
    return harness.per_seed(ctx, seeds, controls, _reading)
