"""The control at test size: the configuration's next precision below,
in the program's place, comes out not correct by the cell's limits,
while the program reads well inside them. (On the card at the cells'
own sizes: portbench/readings.py.)"""

import torch

from portbench import harness
from portbench.tests import small


def _ctx(workload):
    """readings.py's context for the cell, at test size on the CPU."""
    wl, config, mix, limits = harness.cell(harness.benchmark(), workload)
    over = small.OVERRIDE[workload]
    return {'workload': workload, 'seed': None,
            'seconds': small.SECONDS[workload], 'trace': False,
            'device': small.CPU, 'chips': wl['chips'],
            'config': dict(config, **over['config']),
            'mix': dict(mix, **over['mix']), 'limits': limits,
            'plant': None}


def _reading(workload):
    """The cell's driver's readings on the test seed, with the control,
    found by the traffic file's driver name as readings.py finds it."""
    c = _ctx(workload)
    d = harness.driver(c['mix']['driver'])
    return d.readings(c, [small.SEED], {small.SEED})[0], c['limits']


def _fails(reading, limits):
    return any(reading[k] > v for k, v in limits.items())


def test_offline_int8c_control():
    torch.set_num_threads(2)
    r, lim = _reading('o.offline')
    assert not _fails(r['program'], lim)
    assert _fails(r['control'], lim)


def test_image_tf32_control():
    torch.set_num_threads(2)
    r, lim = _reading('od.image')
    assert not _fails(r['program'], lim)
    assert _fails(r['control'], lim)


def test_train_tf32_control():
    r, lim = _reading('od.train4')
    assert not _fails(r['program'], lim)
    for k in ('control', 'fault_half', 'fault_no_exchange'):
        assert _fails(r[k], lim), (k, r[k])
