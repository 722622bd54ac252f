#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one GPU: builds the kernels,
holds each against its plain PyTorch version at the serving path's
shapes, drives the serving-d1 megastep at full ResNet-50 width, and
prints one JSON line for the kernels plus a final status line.

    python3 chip_smoke.py

Phases (any failed check raises and the script exits nonzero):
  1. build the CUDA sources (instaorder_tpu_torch/csrc) with nvcc; print
     the build time and the card's name and power limit;
  2. each kernel vs its plain version on the card, at the serving
     batch: the prep on 4 synthetic 480x640 scenes of 10 instances
     (180 pairs), the bottleneck kernels on the activations the serving
     trunk hands them (the plain trunk's, call by call); both timed with
     CUDA events;
  3. the serving megastep (calibrated, v2-quantized ResNet-50 from seed
     0): launch counts per megastep, pairs/s, and the logits of a few
     pairs against the plain path run on the CPU;
  4. the `kernels` JSON line, then {"ok": true, "device": {...}}.
Exits nonzero without a result when no CUDA device is present.
"""

import json
import subprocess
import sys
import time

SCENES = 4
INSTANCES = 10
HEIGHT, WIDTH = 480, 640
OUT = 256
PASSES = 1                      # serving-d1: 1-pass bf16 prep weights
H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_BF16_PER_S = 989e12        # dense bf16 tensor-core peak
H100_F32_PER_S = 67e12          # f32 outside the tensor cores
PREP_FLOPS_PER_PIXEL = 3 * (4 * 4 + 4) * 2 + 12   # taps + epilogue
PREP = 'fused_prep_pairs'
STAGE = 'fused_bottleneck_i8v2_hwnc_stage'
DOWN = 'fused_bottleneck_down_s2_i8v2_hwnc'
IDEN = 'fused_bottleneck_i8v2_hwnc'
SOURCES = {PREP: 'instaorder_tpu_torch/csrc/prep.cu',
           STAGE: 'instaorder_tpu_torch/csrc/bottleneck_v2.cu',
           DOWN: 'instaorder_tpu_torch/csrc/bottleneck_v2.cu',
           IDEN: 'instaorder_tpu_torch/csrc/bottleneck_v2.cu'}
REPLACES = {PREP: 'instaorder_tpu/ops/prep_pallas.py:315',
            STAGE: 'instaorder_tpu/ops/pallas_blocks.py:1526',
            DOWN: 'instaorder_tpu/ops/pallas_blocks.py:1010',
            IDEN: 'instaorder_tpu/ops/pallas_blocks.py:739'}
EXPECTED_LAUNCHES = {PREP: 1, STAGE: 1, DOWN: 3, IDEN: 10}


def check(ok, what):
    if not ok:
        raise RuntimeError(f'chip_smoke check failed: {what}')


def card_line():
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def cuda_ms(torch, fn, reps=5):
    """Mean device time of fn over reps launches (after one warm-up)."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def diff(torch, what, got, want):
    """Max |got - want| and the share of differing values, printed."""
    torch.cuda.synchronize()
    check(got.dtype == want.dtype and got.shape == want.shape,
          f'{what}: {got.dtype} {tuple(got.shape)} vs {want.dtype} '
          f'{tuple(want.shape)}')
    d = (got.float() - want.float()).abs()
    err, frac = float(d.max()), float((d > 0).float().mean())
    print(f'{what}: max |kernel - plain| {err} on {frac:.2e} of values')
    return err, frac


def block_macs(shape, blk, stride):
    """MACs of one bottleneck on an (N, H, W, Cin) input: conv1 at the
    input resolution, conv2/conv3/projection at the output resolution."""
    n, h, w, cin = shape
    cm, cout = blk['conv1']['w'].shape[-1], blk['conv3']['w'].shape[-1]
    ho, wo = h // stride, w // stride
    macs = n * h * w * cin * cm + n * ho * wo * (9 * cm * cm + cm * cout)
    if 'down' in blk:
        macs += n * ho * wo * cin * cout
    return macs, (n, ho, wo, cout)


def trunk_calls(q, BK):
    """The trunk's kernel calls in _apply_trunk_v2's order: (name,
    kernel(h), plain(h), [(block params, stride)] it covers)."""
    un = lambda c: (c['w'][0, 0], c['b'])
    iden = lambda b: (*un(b['conv1']), b['conv2']['w'], b['conv2']['b'],
                      *un(b['conv3']))
    l1 = q['layer1']
    down = (*iden(l1[0]), *un(l1[0]['down']))
    run, rs = [iden(b) for b in l1[1:]], [b['r'] for b in l1[1:]]
    yield (STAGE, lambda h: BK.fused_bottleneck_i8v2_stage(h, down, run, rs),
           lambda h: BK.fused_bottleneck_i8v2_stage_plain(h, down, run, rs),
           [(b, 1) for b in l1])
    rest = [qb for li in (2, 3, 4) for qb in q[f'layer{li}']]
    for i, qb in enumerate(rest):
        o = i + 1 == len(rest)          # int8 out at the trunk's end only
        if 'down' in qb:
            a = (*iden(qb), *un(qb['down']))
            yield (DOWN,
                   lambda h, a=a, o=o: BK.fused_bottleneck_i8v2_down_s2(
                       h, *a, out_int8=o),
                   lambda h, a=a, o=o: BK.fused_bottleneck_i8v2_down_s2_plain(
                       h, *a, out_int8=o), [(qb, 2)])
        else:
            a = (*iden(qb), qb['r'])
            yield (IDEN,
                   lambda h, a=a, o=o: BK.fused_bottleneck_i8v2_identity(
                       h, *a, out_int8=o),
                   lambda h, a=a, o=o: BK.fused_bottleneck_i8v2_identity_plain(
                       h, *a, out_int8=o), [(qb, 1)])


def check_stage_blocks(torch, BK, q, h):
    """Each block of the layer1 stage on the plain stage's input: the
    one-block bar holds per block. Over the whole stage a tie flip in
    one block's output moves the next block's input, so the stage's own
    bar is one LSB per chained block."""
    for j, qb in enumerate(q['layer1']):
        w = (qb['conv1']['w'][0, 0], qb['conv1']['b'], qb['conv2']['w'],
             qb['conv2']['b'], qb['conv3']['w'][0, 0], qb['conv3']['b'])
        kw = ({'wd': qb['down']['w'][0, 0], 'bd': qb['down']['b']}
              if 'down' in qb else {'r': qb['r']})
        want = BK._block_plain(h, *w, **kw)
        err, frac = diff(torch, f'  stage block {j}',
                         BK._block_cuda(h, *w, **kw), want)
        check(err <= 1 and frac < 0.01, f'stage block {j}: <=1 LSB on <1%')
        h = want
    return len(q['layer1'])


def phase_prep(torch, PK, prep_args, n_pairs):
    x_k = PK.fused_prep_pairs(*prep_args, out_size=OUT, passes=PASSES)
    x_p = PK.fused_prep_pairs_plain(*prep_args, out_size=OUT, passes=PASSES)
    torch.cuda.synchronize()
    check(bool((x_k[..., :2] == x_p[..., :2]).all()), 'prep masks exact')
    err, frac = diff(torch, PREP + ' (RGB)', x_k[..., 2:], x_p[..., 2:])
    check(err <= 0.03125 + 1e-6 and frac < 0.01,
          'prep RGB within one uint8 LSB on <1% of pixels')
    result = dict(
        max_abs_err=err,
        ms=cuda_ms(torch, lambda: PK.fused_prep_pairs(
            *prep_args, out_size=OUT, passes=PASSES)),
        plain_ms=cuda_ms(torch, lambda: PK.fused_prep_pairs_plain(
            *prep_args, out_size=OUT, passes=PASSES), reps=2),
        bytes=nbytes(x_k, *prep_args),
        ops=n_pairs * OUT * OUT * PREP_FLOPS_PER_PIXEL,
        ops_rate=H100_F32_PER_S)
    return x_k, result


def phase_trunk(torch, BK, Q, q, x, results):
    """Walk the trunk: each kernel gets the plain trunk's activation at
    its position; outputs compared, both versions timed."""
    h = Q._stem_v2(q, x)
    for name, kern, plain, blocks in trunk_calls(q, BK):
        bar = check_stage_blocks(torch, BK, q, h) if name == STAGE else 1
        want = plain(h)
        err, frac = diff(torch, f'{name} {tuple(h.shape)}->'
                         f'{tuple(want.shape)} {str(want.dtype)[6:]}',
                         kern(h), want)
        check(err <= bar and frac < 0.01, f'{name}: <={bar} LSB on <1%')
        live = float(((want > 0) & (want < 127)).float().mean())
        check(live > 0.05, f'{name}: {live:.3f} of outputs unclipped')
        macs, shape = 0, tuple(h.shape)
        for blk, stride in blocks:
            m, shape = block_macs(shape, blk, stride)
            macs += m
        weights = [t for blk, _ in blocks
                   for c in ('conv1', 'conv2', 'conv3', 'down') if c in blk
                   for t in blk[c].values()]
        r = results.setdefault(name, dict(
            max_abs_err=0.0, ms=0.0, plain_ms=0.0, bytes=0, ops=0,
            ops_rate=H100_BF16_PER_S))
        r['max_abs_err'] = max(r['max_abs_err'], err)
        r['ms'] += cuda_ms(torch, lambda: kern(h))
        r['plain_ms'] += cuda_ms(torch, lambda: plain(h), reps=2)
        r['bytes'] += nbytes(h, want, *weights)
        r['ops'] += 2 * macs
        h = want


def phase_megastep(torch, serving, Q, tree_to, wrappers, q, cfg, sc, pidx,
                   x, n_pairs, card):
    step = lambda: serving.megastep(q, cfg, *sc, pidx, out_size=OUT,
                                    passes=PASSES)
    for w in wrappers.values():
        w.launches = 0
    logits, ij, ji = step()
    torch.cuda.synchronize()
    launches = {n: w.launches for n, w in wrappers.items()}
    print('launches per megastep:', launches)
    check(launches == EXPECTED_LAUNCHES, f'launch counts {launches}')
    check(tuple(logits.shape) == (n_pairs, 2)
          and bool(torch.isfinite(logits).all()), 'finite (P, 2) logits')

    iters = 10
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f'megastep: {n_pairs} pairs, {dt / iters * 1e3:.3f} ms/step, '
          f'{n_pairs * iters / dt:.1f} pairs/s ({card})')

    # a handful of pairs through the plain path on the CPU
    few = 4
    with torch.no_grad():
        ref = Q.apply_folded_v2(tree_to(q, 'cpu'), cfg, x[:few].cpu())
    got = logits[:few].cpu()
    scale = max(float(ref.abs().max()), 1e-6)
    rel = float((got - ref).abs().max()) / scale
    print(f'logits vs plain CPU path ({few} pairs): max rel err {rel:.3e}')
    print('logits (card):', got.tolist())
    print('logits (cpu): ', ref.tolist())
    check(rel < 0.02 and scale > 1e-3,
          'nonzero logits within 2% of max |logit|')
    p = torch.sigmoid(ref)
    for col, dec in ((1, ij[:few].cpu()), (0, ji[:few].cpu())):
        sure = (p[:, col] - 0.5).abs() > 1e-2
        check(bool((dec[sure] == (p[sure, col] > 0.5)).all()),
              'decisions agree where the reference is sure')
    return launches


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2
    from instaorder_tpu_torch import serving
    from instaorder_tpu_torch.convert import tree_to
    from instaorder_tpu_torch.device import resolve_device
    from instaorder_tpu_torch.models import quantize as Q
    from instaorder_tpu_torch.ops import _build
    from instaorder_tpu_torch.ops import bottleneck_kernels as BK
    from instaorder_tpu_torch.ops import pairs as P
    from instaorder_tpu_torch.ops import prep_kernels as PK

    dev = resolve_device()
    card = card_line()
    print(card)
    print(f'torch {torch.__version__} cuda {torch.version.cuda} '
          f'device {torch.cuda.get_device_name(0)}')

    # ---- 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    print(f'build: {time.perf_counter() - t0:.2f} s (nvcc '
          f'{_build.BUILD_INFO["seconds"]:.2f} s)')
    print(_build.BUILD_INFO['log'])

    # ---- 2. kernels vs plain at the serving shapes -------------------------
    images, masks, bboxes = serving.synthetic_scenes(
        SCENES, HEIGHT, WIDTH, INSTANCES, seed=0)
    sc = serving.upload_scenes(images, masks, bboxes, device=dev)
    pidx = torch.as_tensor(P.all_pair_indices(INSTANCES)[0],
                           dtype=torch.int32, device=dev)
    rois = P.pair_rois(sc[2], pidx).contiguous()
    n_pairs = SCENES * pidx.shape[0]
    results = {}
    x, results[PREP] = phase_prep(torch, PK, (sc[0], sc[1], pidx, rois),
                                  n_pairs)
    # the serving model, calibrated on this prepped batch (as bench.py).
    # kaiming init: bench.py's xavier(0.02) trunk quantizes every
    # activation to 0, which would make every comparison vacuous
    t0 = time.perf_counter()
    q, cfg = serving.build_serving_model(0, x, device=dev,
                                         weight_init='kaiming_out')
    torch.cuda.synchronize()
    print(f'build_serving_model: {time.perf_counter() - t0:.2f} s')
    with torch.no_grad():
        phase_trunk(torch, BK, Q, q, x, results)

    # ---- 3. the serving megastep --------------------------------------------
    wrappers = {PREP: PK.fused_prep_pairs,
                STAGE: BK.fused_bottleneck_i8v2_stage,
                DOWN: BK.fused_bottleneck_i8v2_down_s2,
                IDEN: BK.fused_bottleneck_i8v2_identity}
    launches = phase_megastep(torch, serving, Q, tree_to, wrappers, q, cfg,
                              sc, pidx, x, n_pairs, card)

    # ---- 4. report ----------------------------------------------------------
    kernels = []
    for name, r in results.items():
        t_bytes = r['bytes'] / H100_BYTES_PER_S * 1e3
        t_ops = r['ops'] / r['ops_rate'] * 1e3
        kernels.append({
            'name': name, 'route': 'cuda', 'source': SOURCES[name],
            'replaces': REPLACES[name], 'launches': launches[name],
            'max_abs_err': r['max_abs_err'], 'ms': r['ms'],
            'plain_ms': r['plain_ms'], 'bound_ms': max(t_bytes, t_ops),
            'bound_by': 'bytes' if t_bytes >= t_ops else 'operations',
            'library_ms': None})
    print(card)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
