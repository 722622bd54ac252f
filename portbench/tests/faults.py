"""Faults planted under a run's timed path (the fault tests, and
`readings.py --plant` at a cell's own size on the card). Each `plant_*`
takes the rank (0 in a one-process cell) and breaks the program in this
process; the harness calls it after set-up's imports and before the
program is built."""

import sys
import types

import torch


def _patch(mod, name, make):
    setattr(mod, name, make(getattr(mod, name)))


def plant_offline_altered(rank):
    """The megastep's logits altered where they are produced."""
    from instaorder_tpu_torch import serving

    def make(real):
        def megastep(*a, **k):
            logits, i_j, j_i = real(*a, **k)
            return logits + 0.5, i_j, j_i
        return megastep
    _patch(serving, 'megastep', make)


def plant_offline_half(rank):
    """Half of each step's pairs left out, the rest answered."""
    from instaorder_tpu_torch import serving

    def make(real):
        def megastep(*a, **k):
            logits, i_j, j_i = real(*a, **k)
            n = logits.shape[0] // 2
            return logits[:n], i_j[:n], j_i[:n]
        return megastep
    _patch(serving, 'megastep', make)


def _zero_conv2(block):
    """A block's 3x3 convolution made to output zeros (its weights and
    bias zeroed before the kernels' layouts are made from them)."""
    c2 = block['conv2']
    c2['w'] = torch.zeros_like(c2['w'])
    c2['b'] = torch.zeros_like(c2['b'])


def plant_offline_block(rank):
    """One identity block's 3x3 GEMM (layer3, block 2, run by the v2 block
    kernel) giving zeros."""
    from instaorder_tpu_torch.models import quantize

    def make(real):
        def quantize_folded_v2(*a, **k):
            q = real(*a, **k)
            _zero_conv2(q['layer3'][2])
            return q
        return quantize_folded_v2
    _patch(quantize, 'quantize_folded_v2', make)


def plant_image_block(rank):
    """One identity block's 3x3 GEMM (layer2, block 1, run by the f32
    block kernel) giving zeros."""
    from instaorder_tpu_torch.eval import pipeline

    def make(real):
        def fold_resnet(*a, **k):
            folded = real(*a, **k)
            _zero_conv2(folded['layer2'][1])
            return folded
        return fold_resnet
    _patch(pipeline, 'fold_resnet', make)


def plant_image_altered(rank):
    """The trunk's depth logits altered where they are produced."""
    from instaorder_tpu_torch.models import folding

    def make(real):
        def trunk(*a, **k):
            occ, dep = real(*a, **k)
            return occ, dep.flip(-1)
        return trunk
    _patch(folding, '_apply_trunk', make)


def plant_image_half(rank):
    """Half of each image's pairs left out of the matrices."""
    from instaorder_tpu_torch.eval import pipeline

    def make(real):
        def pair_outputs(self, *a, **k):
            pair_idx, valid, o1, o2, n = real(self, *a, **k)
            keep = torch.arange(valid.shape[0], device=valid.device) % 2 == 0
            return pair_idx, valid & keep, o1, o2, n
        return pair_outputs
    _patch(pipeline.OrderPredictor, 'pair_outputs', make)


def plant_train_unchanged(rank):
    """A step that returns its state unchanged."""
    from instaorder_tpu_torch.train import step

    def make(real):
        def build(loss_fn, optimizer, mesh=None):
            inner = real(loss_fn, optimizer, mesh)

            def one(params, stats, opt_state, batch, lr):
                _p, _s, new_opt, logs = inner(params, stats, opt_state,
                                              batch, lr)
                return params, stats, new_opt, logs
            return one
        return build
    _patch(step, 'build_train_step', make)


def plant_train_half(rank):
    """Half of each rank's batch left out, the loss the mean over the
    rest."""
    from instaorder_tpu_torch.train import algos

    def make(real):
        def make_loss(*a, **k):
            inner = real(*a, **k)

            def loss_fn(params, stats, batch, train=True):
                n = batch['rgb'].shape[0] // 2
                return inner(params, stats, {key: v[:n] for key, v in
                                             batch.items()}, train)
            return loss_fn
        return make_loss
    _patch(algos, 'make_loss', make)


def plant_train_no_exchange(rank):
    """The gradient all-reduce between the ranks left out."""
    from instaorder_tpu_torch.train import step
    step.all_reduce_mean = lambda tree, group=None: tree


def plant_train_altered(rank):
    """The step's loss altered where it is produced."""
    from instaorder_tpu_torch.train import step

    def make(real):
        def build(loss_fn, optimizer, mesh=None):
            inner = real(loss_fn, optimizer, mesh)

            def one(*a, **k):
                p, s, o, logs = inner(*a, **k)
                return p, s, o, dict(logs, loss=logs['loss'] * 1.01)
            return one
        return build
    _patch(step, 'build_train_step', make)


def plant_train_loads_jax(rank):
    """JAX loaded in one rank process (a stand-in module under its name)."""
    if rank == 1:
        sys.modules['jax'] = types.ModuleType('jax')
