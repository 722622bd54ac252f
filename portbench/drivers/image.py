"""Per-image ordering: one client calling the public per-image API in a
closed loop, one image a call.

Set-up: the seeded weights (heads centred on the reference's features
of the first images' pairs), the predictor from the configuration's
factory (`eval.pipeline.make_folded_predictor`, its route and mode),
the images of the mix's instance-count multiset as numpy arrays, and
one warm-up call for each pair bucket the multiset reaches.

Window: whole passes of the multiset, each in an order drawn from the
seed, ending at the pass boundary nearest to the run's seconds; each
call timed on the host clock from its start to the returned numpy
matrices. The traced run then profiles one more pass of
the multiset, the trunk (`folding._apply_trunk`) inside a range.

Check: a seeded sample of the window's images, the one with the most
instances always in it, against the reference worked out again from
the same weights and images: the shared resize, the f32 folded net in
both mask orders, both heads' logits, both matrices.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import harness, traffic, weights, yardstick
from ..reference import model as R
from ..reference import prep as RP
from .offline import port_cfg


def _pairs(n):
    return n * (n - 1) // 2


def predictor(ctx, params, stats):
    """The configuration's predictor over the harness's weights."""
    from instaorder_tpu_torch.eval import pipeline
    config = ctx['config']
    feats = config['use_pallas']
    return pipeline.make_folded_predictor(
        params, stats, port_cfg(config), config['algo'], dtype=None,
        use_pallas=tuple(feats) if isinstance(feats, list) else feats,
        patch_or_image=config['patch_or_image'],
        input_size=config['input_size'], directions=config['directions'],
        device=ctx['device'])


def setup(ctx):
    """The multiset's images, the seeded weights, the predictor (its
    siamese forward's logits kept for the check), the warm-up images."""
    from instaorder_tpu_torch.eval.pipeline import bucket_pairs
    dev, config, mix, seed = ctx['device'], ctx['config'], ctx['mix'], ctx['seed']
    counts = list(mix['instance_counts'])
    imgs = traffic.images(seed, 20, counts, mix, dev)
    params, stats = weights.make_trunk(seed, dev, config['in_channels'],
                                       config['bn3_gain'])
    xs, k = [], 0
    while sum(x.shape[0] for x in xs) < mix['centre_pairs']:
        img, m, _ = imgs[k]
        xs.append(RP.shared_batch(torch.as_tensor(img, device=dev),
                                  torch.as_tensor(m, device=dev),
                                  RP.upper_pairs(counts[k]),
                                  config['input_size']))
        k += 1
    x = torch.cat(xs)[:mix['centre_pairs']]
    feats = R.forward_folded(R.fold(params, stats),
                             torch.cat([x, RP.swap_masks(x)]), features=True)
    weights.centred_heads(params, seed, config['num_classes'], feats)
    pred = predictor(ctx, params, stats)
    logits = []
    real = pred.siamese_fn

    def siamese(*a, **k):
        out = real(*a, **k)
        logits.append(out)
        return out
    pred.siamese_fn = siamese
    warm = {}
    for i, n in enumerate(counts):
        warm.setdefault(bucket_pairs(max(_pairs(n), 1)), i)
    return {'pred': pred, 'imgs': imgs, 'counts': counts, 'logits': logits,
            'warm': sorted(warm.values()), 'params': params, 'stats': stats}


def call(st, i):
    img, m, bb = st['imgs'][i]
    return st['pred'].infer_occ_depth_order(img, m, bb)


def window(ctx, st, seconds):
    """Whole passes of the multiset, each in a seeded order, ending at the
    pass boundary nearest to `seconds` (at least one pass), so that every
    image of the multiset counts as often as every other: -> (calls
    [(image index, ms, occ, depth)], s)."""
    rng = np.random.default_rng(weights.subseed(ctx['seed'], 21))
    calls, passes = [], 0
    t0 = time.perf_counter()
    while True:
        for i in rng.permutation(len(st['counts'])):
            t = time.perf_counter()
            occ, dep = call(st, int(i))
            calls.append((int(i), (time.perf_counter() - t) * 1e3, occ, dep))
        passes += 1
        spent = time.perf_counter() - t0
        if spent + spent / (2 * passes) >= seconds:
            return calls, spent


def reference_logits(ctx, img, masks, n, tf32=False):
    """The reference's ((occ1, dep1), (occ2, dep2)) over the image's
    pairs in both mask orders."""
    dev, out = ctx['device'], ctx['config']['input_size']
    x = RP.shared_batch(torch.as_tensor(img, device=dev),
                        torch.as_tensor(masks, device=dev),
                        RP.upper_pairs(n), out)
    x = torch.cat([x, RP.swap_masks(x)])
    with R.tf32(tf32):
        lg = [R.forward_folded(ctx['ref_folded'], x[i:i + 64])
              for i in range(0, x.shape[0], 64)]
    occ = torch.cat([g[0] for g in lg])
    dep = torch.cat([g[1] for g in lg])
    P = _pairs(n)
    return (occ[:P], dep[:P]), (occ[P:], dep[P:])


def sample(ctx, st, calls):
    """The calls the check compares: the one with the most instances and
    a seeded draw of the others, mix['check_images'] in all."""
    counts = st['counts']
    rng = np.random.default_rng(weights.subseed(ctx['seed'], 22))
    k = min(ctx['mix']['check_images'], len(calls))
    longest = max(range(len(calls)), key=lambda c: counts[calls[c][0]])
    rest = [c for c in range(len(calls)) if c != longest]
    return [longest] + [int(c) for c in rng.choice(rest, size=k - 1,
                                                   replace=False)]


def matrices_of(n, o1, d1, o2, d2):
    """The reference's decode of both directions' logits: (occ, depth)."""
    pij, pji = RP.occ_probs(o1, o2)
    return RP.matrices(n, RP.upper_pairs(n), pij, pji,
                       RP.depth_probs(d1, d2))


def compare(ctx, st, calls):
    """The window's calls against the reference on a seeded sample of
    images: the logits of both heads in both directions (their widest
    gap over each head's spread), every matrix cell whose reference
    decision is sure beyond that gap, and every call's matrices of the
    right shape."""
    counts = st['counts']
    pick = sample(ctx, st, calls)
    bad = sum(1 for i, _ms, occ, dep in calls
              if occ.shape != (counts[i],) * 2 or dep.shape != (counts[i],) * 2)
    ctx['ref_folded'] = R.fold(st['params'], st['stats'])
    rows = []
    for c in pick:
        i, _ms, occ, dep = calls[c]
        img, m, _ = st['imgs'][i]
        n = counts[i]
        P = _pairs(n)
        (o1, d1), (o2, d2) = st['logits'][c]
        ref = reference_logits(ctx, img, m, n)
        rows.append((n, occ, dep, [o1[:P], d1[:P], o2[:P], d2[:P]],
                     [ref[0][0], ref[0][1], ref[1][0], ref[1][1]]))
    s_occ = torch.cat([r[4][0] for r in rows] + [r[4][2] for r in rows]).std()
    s_dep = torch.cat([r[4][1] for r in rows] + [r[4][3] for r in rows]).std()
    gap, flips, sure = 0.0, 0, 0
    lim = ctx['limits']['logit_gap']
    for n, occ, dep, prog, ref in rows:
        for a, b, s in zip(prog, ref, (s_occ, s_dep, s_occ, s_dep)):
            if a.shape != b.shape:
                gap = float('inf')
                continue
            gap = max(gap, ((a.float() - b).abs().max() / s).item())
        pij, pji = RP.occ_probs(ref[0], ref[2])
        dprob = RP.depth_probs(ref[1], ref[3])
        ro, rd = matrices_of(n, *ref)
        top2 = dprob.topk(2, dim=1).values
        # a gap of lim * s moves a sigmoid by at most lim * s / 4 and a
        # softmax share by at most lim * s / 2 in each direction
        sure_o = ((pij - 0.5).abs() > lim * s_occ / 4) & \
            ((pji - 0.5).abs() > lim * s_occ / 4)
        sure_d = (top2[:, 0] - top2[:, 1]) > lim * s_dep
        if occ.shape != ro.shape or dep.shape != rd.shape:
            flips += 1
            continue
        for k2, (i, j) in enumerate(RP.upper_pairs(n)):
            if bool(sure_o[k2]):
                sure += 1
                flips += int(occ[i, j] != ro[i, j] or occ[j, i] != ro[j, i])
            if bool(sure_d[k2]):
                sure += 1
                flips += int(dep[i, j] != rd[i, j] or dep[j, i] != rd[j, i])
    return [harness.check('answers_missing', bad, 0),
            harness.check('logit_gap', gap, lim),
            harness.check('sure_flips', flips, 0)], {
        'checked_images': len(pick), 'sure': sure, 'scale_occ': float(s_occ),
        'scale_depth': float(s_dep)}


def run(ctx):
    """One run of the cell: set-up, the window, with ctx['trace'] the
    traced stretch, then the check. Returns what `harness.result_line`
    reads: t_window, attempted, failed, end_to_end, records, checks,
    info, device."""
    dev = ctx['device']
    harness.plant(ctx)
    st = setup(ctx)
    for i in st['warm']:
        call(st, i)
    st['logits'].clear()
    t_window = time.time()
    calls, secs = window(ctx, st, ctx['seconds'])
    ms = [c[1] for c in calls]
    cfg = ctx['config']
    valid = sum(_pairs(st['counts'][c[0]]) for c in calls)
    rec = {'chips': 1, 'window_s': secs, 'config': cfg,
           'useful_flops': valid * 2 * yardstick.forward_flops(cfg)}
    if ctx['trace']:
        rec['trace'] = trace(ctx, st)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == 'cuda' else 0
    st['pred'] = None
    if dev.type == 'cuda':
        torch.cuda.empty_cache()
    checks, info = compare(ctx, st, calls)
    p95 = float(np.percentile(ms, 95)) if ms else float('nan')
    return {'t_window': t_window, 'attempted': len(calls), 'failed': 0,
            'end_to_end': {'image_ms_p95': p95,
                           'images_per_s': len(calls) / secs},
            'records': rec, 'checks': checks,
            'info': dict(info, images=len(calls),
                         median_ms=float(np.median(ms)) if ms else None),
            'device': harness.device_info(dev, 1, peak)}


def trace(ctx, st):
    """One pass of the multiset under the profiler, the trunk in a range; ->
    the reduced trace with the trunk calls' batch sizes and the valid
    pairs of the calls."""
    from instaorder_tpu_torch.models import folding
    real = folding._apply_trunk
    calls = []

    def trunk(params, cfg, out, *a, **k):
        calls.append(int(out.shape[0]))
        return real(params, cfg, out, *a, **k)
    folding._apply_trunk = harness.traced(trunk, ctx['device'])
    kept = len(st['logits'])
    rng = np.random.default_rng(weights.subseed(ctx['seed'], 23))
    idx = [int(i) for i in rng.permutation(len(st['counts']))]
    sync = torch.cuda.synchronize if ctx['device'].type == 'cuda' \
        else (lambda: None)
    try:
        with harness.profiler(ctx['device']) as prof:
            with torch.profiler.record_function(harness.WINDOW):
                for i in idx:
                    call(st, i)
                sync()
    finally:
        folding._apply_trunk = real
    red = harness.reduce_trace(prof)
    if red is not None:
        red['trunk_batches'] = calls
        red['valid_pairs'] = [2 * _pairs(st['counts'][i]) for i in idx]
    del st['logits'][kept:]
    return red


def _reading(ctx, control):
    """The compared numbers of the program (the per-image predictor over a
    short window) and, with `control`, of the control: the reference in
    TF32 in the program's place, on the same calls."""
    st = setup(ctx)
    for i in st['warm']:
        call(st, i)
    st['logits'].clear()
    calls, _ = window(ctx, st, ctx['seconds'])
    st['pred'] = None
    checks, info = compare(ctx, st, calls)
    out = {'program': dict({c['name']: c['value'] for c in checks}, **info)}
    if control:
        pick = set(sample(ctx, st, calls))
        fake_calls, fake_logits = [], []
        for c, (i, ms, occ, dep) in enumerate(calls):
            lg = None
            if c in pick:
                img, m, _ = st['imgs'][i]
                n = st['counts'][i]
                (o1, d1), (o2, d2) = lg = reference_logits(
                    ctx, img, m, n, tf32=True)
                occ, dep = matrices_of(n, o1, d1, o2, d2)
            fake_calls.append((i, ms, occ, dep))
            fake_logits.append(lg)
        checks, info = compare(ctx, dict(st, logits=fake_logits), fake_calls)
        out['control'] = dict({c['name']: c['value'] for c in checks}, **info)
    return out


def readings(ctx, seeds, controls):
    """readings.py's lines: `_reading` on each seed."""
    return harness.per_seed(ctx, seeds, controls, _reading)
