"""The yardstick's counts: MACs and bytes from the layer shapes."""

import pytest

from portbench import yardstick
from portbench.reference.macs import resnet50_blocks, resnet50_macs


def test_resnet50_at_224_is_torchvisions_4_09_g():
    assert resnet50_macs(3, 224, 224, 1000) == 4_089_184_256


def test_a_bottleneck_by_hand():
    b = {x['name']: x for x in resnet50_blocks(5, 256, 256)}
    # layer2.0: 64x64x256 in, stride 2, planes 128, 32x32x512 out
    l2 = b['layer2.0']
    assert l2['macs'] == (64 * 64 * 256 * 128 + 32 * 32 * 9 * 128 * 128
                          + 32 * 32 * 128 * 512 + 32 * 32 * 256 * 512)
    assert l2['in'] == 64 * 64 * 256 and l2['out'] == 32 * 32 * 512
    assert l2['weights'] == 256 * 128 + 9 * 128 * 128 + 128 * 512 + 256 * 512
    # an identity block of layer1: no projection
    l1 = b['layer1.1']
    assert l1['macs'] == 64 * 64 * (256 * 64 + 9 * 64 * 64 + 64 * 256)
    assert b['stem']['macs'] == 128 * 128 * 64 * 5 * 49


def test_trunk_bound_of_one_block_by_hand():
    cfg = {'input_size': 256, 'in_channels': 5, 'num_classes': 2,
           'peak': 'bf16', 'storage_bytes': {'activation': 1, 'weight': 2}}
    blocks = [b for b in resnet50_blocks(5, 256, 256) if b['name'] != 'stem']
    want = 0.0
    for b in blocks:
        flops = 2.0 * b['macs'] * 10
        nbytes = 10 * (b['in'] + b['out']) * 1 + b['weights'] * 2
        want += max(flops / 989e12, nbytes / 3.35e12)
    assert yardstick.trunk_bound_s(cfg, 10) == pytest.approx(want)
    # at serving batches every block is bound by its operations
    l1 = blocks[0]
    assert 2.0 * l1['macs'] * 1620 / 989e12 > (
        1620 * (l1['in'] + l1['out']) + 2 * l1['weights']) / 3.35e12


def test_forward_flops_count_both_heads():
    od = {'input_size': 384, 'in_channels': 5, 'num_classes': [2, 3]}
    assert yardstick.forward_flops(od) == 2.0 * resnet50_macs(5, 384, 384, 5)


def test_allreduce_counts_each_collectives_shortest_rank():
    from portbench.drivers.train import least_nccl
    from portbench.readers import allreduce_ms
    # rank 0 waited 7 ms for the others on the first all-reduce
    ranks = [{'nccl_kernels': [0.009, 0.002]},
             {'nccl_kernels': [0.002, 0.003]}]
    assert least_nccl(ranks) == pytest.approx(0.004)
    rec = {'trace': {'steps': 2, 'nccl_least_s': least_nccl(ranks)}}
    assert allreduce_ms(rec) == pytest.approx(2.0)
    assert least_nccl([{'nccl_kernels': [0.004]},
                       {'nccl_kernels': [0.002, 0.003]}]) == 0.004
    assert least_nccl([{'nccl_kernels': []}, {'nccl_kernels': []}]) is None
    assert allreduce_ms({'trace': {'steps': 2, 'nccl_least_s': None}}) is None
