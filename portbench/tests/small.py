"""Test sizes: each cell's published widths with its traffic cut to what
a CPU test holds (the nets stay full ResNet-50s; inputs, scenes, pairs
and batches are small)."""

import torch

CPU = torch.device('cpu')
SEED = 2 ** 31 + 11

OVERRIDE = {
    'o.offline': {
        'config': {'input_size': 64},
        'mix': {'scenes_per_step': 2, 'height': 96, 'width': 128,
                'instances': 4, 'box_min': 10, 'box_max': 40,
                'pool_steps': 2, 'check_pairs': 12, 'warm_steps': 1,
                'trace_steps': 1}},
    'od.image': {
        'config': {'input_size': 64},
        'mix': {'height': 96, 'width': 128, 'box_min': 8, 'box_max': 40,
                'instance_counts': [2, 3, 4, 6], 'centre_pairs': 12,
                'check_images': 3}},
    'od.train4': {
        'config': {'batch_size_per_rank': 2},
        'mix': {'size': 64, 'box_min': 8, 'box_max': 40, 'pool': 4,
                'size_steps': 1, 'trace_steps': 1}},
}

SECONDS = {'o.offline': 1.0, 'od.image': 1.5, 'od.train4': 1.0}


def run(workload, plant=None, seed=SEED):
    """One run of the cell on the CPU at test size: (result, output)."""
    from portbench import run as R
    torch.set_num_threads(2)
    return R.run_cell(workload, seed, SECONDS[workload], 0, CPU,
                      plant=plant, override=OVERRIDE[workload])
