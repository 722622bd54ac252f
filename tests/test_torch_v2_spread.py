"""How far the v2 kernel route may sit from the v2 XLA route, measured on
the CPU at `chip_smoke.py`'s smoke cell, and where the port sits.

`chip_smoke.py` holds the serving-d1 megastep's logits on the card (the
v2 kernels) within 2% of max |logit| of the port's plain path on 4 pairs
and prints the error over all 180 pairs (2.05e-2 on an H100). Boundary
round() ties flip one int8 LSB and cascade through 16 blocks on random
weights, so the kernel route and the XLA route of the JAX package differ
by themselves. This script measures that spread, on the same model
(the port's smoke-cell model: seed 0, kaiming init, calibrated on the
1-pass prep of the 4 synthetic 480x640 scenes) and the same pairs:

  jax pallas vs jax xla   JAX `apply_folded_v2`, its Pallas kernels in
                          interpret mode, against its XLA route;
  port plain vs jax xla   the port's plain path with the default kernel
                          features (the CPU runs each kernel's plain
                          version) against JAX's XLA route;
  port xla vs jax xla     the port's cuDNN-equivalent route (use_pallas
                          False) against JAX's XLA route;
  port plain vs jax pallas.

Each is max |a - b| / max |b| over the pairs so far, printed as each
chunk of pairs finishes, then one JSON line. Run:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_v2_spread.py --pairs 12

The test below runs the same comparison at the small test geometry
(ResNet-50 widths, layers (2, 2, 1, 1), 64x64 crops, 6 inputs) and holds
the port to JAX: each port route departs from the same JAX route (plain
kernel versions from the Pallas kernels, the conv route from XLA) by
less than the JAX package's own kernel-vs-XLA spread.
"""

import argparse
import json
import time

import numpy as np
import jax
import jax.numpy as jnp
import torch

from instaorder_tpu.models import quantize as JQ
from instaorder_tpu.ops import pallas_blocks

from instaorder_tpu_torch import serving
from instaorder_tpu_torch.models import quantize as TQ
import torch_threads  # noqa: F401 (the suite's torch thread cap)

# the JAX kernels of the v2 default feature set (hwnc, down2, hwncs1d)
KERNELS = ('fused_bottleneck_i8v2_hwnc', 'fused_bottleneck_i8v2_hwnc_stage',
           'fused_bottleneck_down_s2_i8v2_hwnc')


def to_jax(tree):
    """A port tree -> the JAX package's tree: tensors to jnp arrays of the
    same dtype (bf16 kept), Python floats as they are."""
    if isinstance(tree, dict):
        return {k: to_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_jax(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        if tree.dtype == torch.bfloat16:
            return jnp.asarray(tree.float().numpy()).astype(jnp.bfloat16)
        return jnp.asarray(tree.numpy())
    return tree


def interpret_kernels():
    """Every JAX kernel of the v2 default route in interpret mode; returns
    the originals for restore_kernels."""
    saved = {n: getattr(pallas_blocks, n) for n in KERNELS}
    for n, o in saved.items():
        setattr(pallas_blocks, n, (lambda o: lambda *a, **kw: o(
            *a, **dict(kw, interpret=True)))(o))
    return saved


def restore_kernels(saved):
    for n, o in saved.items():
        setattr(pallas_blocks, n, o)


def _rel(a, b):
    return float(np.abs(a - b).max() / max(float(np.abs(b).max()), 1e-6))


def routes(q, cfg, x):
    """Logits of the four routes on x (N, H, W, 5) bf16: (jax xla, jax
    pallas in interpret mode, port plain with the default features, port
    with use_pallas=False), each (N, 2) f32 numpy."""
    qj, xj = to_jax(q), to_jax(x)
    jx = np.asarray(JQ.apply_folded_v2(qj, cfg, xj, use_pallas=False))
    saved = interpret_kernels()
    try:
        jp = np.asarray(JQ.apply_folded_v2(qj, cfg, xj, use_pallas=True))
    finally:
        restore_kernels(saved)
    with torch.no_grad():
        tp = TQ.apply_folded_v2(q, cfg, x, use_pallas=True).numpy()
        tx = TQ.apply_folded_v2(q, cfg, x, use_pallas=False).numpy()
    return jx, jp, tp, tx


def spreads(jx, jp, tp, tx):
    return {'jax pallas vs jax xla': _rel(jp, jx),
            'port plain vs jax xla': _rel(tp, jx),
            'port xla vs jax xla': _rel(tx, jx),
            'port plain vs jax pallas': _rel(tp, jp)}


def smoke_cell(seed=0):
    """The port's serving-d1 smoke-cell model and prepped pairs, on the
    CPU: chip_smoke.py's 4 scenes of 10 instances (180 pairs), the
    1-pass 5-channel prep, the model from `seed` with kaiming init
    calibrated on that batch."""
    images, masks, bboxes = serving.synthetic_scenes(4, 480, 640, 10,
                                                     seed=0)
    sc = serving.upload_scenes(images, masks, bboxes, device='cpu')
    from instaorder_tpu_torch.ops import pairs as P
    pidx = torch.as_tensor(P.all_pair_indices(10)[0], dtype=torch.int32)
    x = serving.prep_pairs(*sc, pidx, out_size=256, passes=1,
                           prep_rgb='pallas5')
    q, cfg = serving.build_serving_model(seed, x, device='cpu',
                                         weight_init='kaiming_out')
    return q, cfg, x


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--pairs', type=int, default=12)
    ap.add_argument('--chunk', type=int, default=4)
    args = ap.parse_args()
    torch.set_num_threads(4)
    t0 = time.perf_counter()
    q, cfg, x = smoke_cell()
    print(f'model and prep: {time.perf_counter() - t0:.1f} s', flush=True)
    outs = []
    for i in range(0, args.pairs, args.chunk):
        t1 = time.perf_counter()
        outs.append(routes(q, cfg, x[i:min(i + args.chunk, args.pairs)]))
        cat = [np.concatenate(o) for o in zip(*outs)]
        print(f'pairs 0..{cat[0].shape[0] - 1} '
              f'({time.perf_counter() - t1:.1f} s): '
              f'{json.dumps(spreads(*cat))}', flush=True)
    print(json.dumps({'pairs': int(cat[0].shape[0]), **spreads(*cat)}))


def test_port_within_jax_kernel_spread():
    from instaorder_tpu.models import resnet as jresnet
    from instaorder_tpu.models.folding import fold_resnet
    from instaorder_tpu_torch import convert
    params, stats, cfg = jresnet.init(
        jax.random.PRNGKey(0), arch='resnet50', in_channels=5,
        num_classes=2, layers_override=(2, 2, 1, 1),
        weight_init='kaiming_out')
    folded = jax.device_get(fold_resnet(params, stats, cfg))
    rng = np.random.RandomState(0)
    x = rng.randn(6, 64, 64, 5).astype(np.float32)
    scales = jax.device_get(JQ.calibrate_folded_resnet(folded, cfg, [x]))
    q = convert.to_torch(jax.device_get(JQ.quantize_folded_v2(
        folded, cfg, scales, compute_dtype=jnp.bfloat16)))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    s = spreads(*routes(q, cfg, xt))
    own = s['jax pallas vs jax xla']
    assert own > 0, s
    assert s['port plain vs jax pallas'] < own, s
    assert s['port xla vs jax xla'] < own, s


if __name__ == '__main__':
    main()
