"""BENCHMARK.json against the contract's shape rules, and every cell's
files found by name."""

import json
import re
import shutil
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
KEYS = {'command', 'paths', 'run_seconds', 'configs', 'workloads',
        'end_to_end', 'per_layer'}


@pytest.fixture(scope='module')
def bench():
    return json.loads((ROOT / 'BENCHMARK.json').read_text())


def _one_line(s):
    return 1 <= len(s) <= 200 and '\n' not in s and '\t' not in s


def test_keys_and_limits(bench):
    assert set(bench) == KEYS
    assert (ROOT / 'BENCHMARK.json').stat().st_size <= 64 * 1024
    assert bench['command'][:2] == ['python3', 'portbench/run.py']
    assert bench['paths'] == ['portbench']
    assert 1 <= bench['run_seconds'] <= 51
    cells = len(bench['workloads'])
    assert 1 <= cells <= 24 and 1 <= len(bench['configs']) <= 24
    full = (2 + 14 * 24) * (bench['run_seconds'] + 60) + 24 * 180 + 1200
    assert full <= 43200


def test_names_units_and_entries(bench):
    names = []
    for c in bench['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert NAME.match(c['name']) and _one_line(c['why'])
        assert _one_line(c['source']) and c['source'].startswith('https://')
        assert c['file'].startswith('portbench/')
        assert all(NAME.match(k) for k in c['reduced'])
        names.append(c['name'])
    used = set()
    for w in bench['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert NAME.match(w['name']) and NAME.match(w['traffic'])
        assert w['config'] in names and w['chips'] in (1, 4)
        assert _one_line(w['why'])
        used.add(w['config'])
        names.append(w['name'])
    assert used == {c['name'] for c in bench['configs']}
    four = sum(w['chips'] == 4 for w in bench['workloads'])
    assert four <= max(1, len(bench['workloads']) // 4)
    pairs = [(w['config'], w['traffic']) for w in bench['workloads']]
    assert len(pairs) == len(set(pairs))
    for m in bench['end_to_end']:
        assert set(m) <= {'name', 'unit', 'better', 'bound', 'source',
                          'workloads'}
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
        names.append(m['name'])
    assert any(m['name'] == 'setup_s' and 'workloads' not in m
               for m in bench['end_to_end'])
    for m in bench['per_layer']:
        assert set(m) <= {'name', 'unit', 'better', 'source', 'layer',
                          'moves', 'workloads'}
        assert _one_line(m['layer'])
        assert m['source'] in ('device_trace', 'program_span',
                               'program_counter', 'host_clock')
        names.append(m['name'])
    for m in bench['end_to_end'] + bench['per_layer']:
        assert NAME.match(m['name']) and UNIT.match(m['unit'])
        assert m['better'] in ('lower', 'higher')
    assert len(names) == len(set(names))


def test_every_cell_reports_what_it_must(bench):
    for w in bench['workloads']:
        e2e = {m['name'] for m in harness.cell_metrics(bench, w['name'],
                                                       'end_to_end')}
        per = harness.cell_metrics(bench, w['name'], 'per_layer')
        assert 'setup_s' in e2e and len(e2e) >= 2 and per
        for m in per:
            assert m['moves'] in e2e, (w['name'], m['name'])


def test_every_file_found_by_name(bench):
    for w in bench['workloads']:
        wl, config, mix, limits = harness.cell(bench, w['name'])
        assert config['name'] == w['config']
        d = harness.driver(mix['driver'])
        assert callable(d.run) and callable(d.readings)
        assert limits
    for m in bench['per_layer']:
        assert callable(harness.reader(m['name']).read)
        assert harness.reader(m['name']).read({}) is None
    for c in bench['configs']:
        assert (ROOT / c['file']).is_file()


def test_a_new_cell_takes_only_new_files(tmp_path, bench):
    """A cell, a traffic mix, a configuration and a per-layer metric added
    by new files and BENCHMARK.json entries: no file that is there
    changes, and the harness finds them all."""
    dst = tmp_path / 'portbench'
    shutil.copytree(ROOT / 'portbench', dst,
                    ignore=shutil.ignore_patterns('__pycache__'))
    before = {p: p.read_bytes() for p in dst.rglob('*') if p.is_file()}
    cfg = json.loads((dst / 'configs' / 'instaordernet_o.json').read_text())
    (dst / 'configs' / 'instaordernet_o_d2.json').write_text(json.dumps(
        dict(cfg, name='instaordernet_o_d2', directions=2)))
    mix = json.loads((dst / 'traffic' / 'offline.json').read_text())
    (dst / 'traffic' / 'offline_dense.json').write_text(json.dumps(
        dict(mix, instances=16)))
    (dst / 'limits' / 'o_d2.dense.json').write_text(
        (dst / 'limits' / 'o.offline.json').read_text())
    (dst / 'metrics' / 'step_mfu.dense.py').write_text(
        'from portbench.readers import step_mfu as read  # noqa: F401\n')
    b = json.loads(json.dumps(bench))
    b['configs'].append({'name': 'instaordernet_o_d2',
                         'source': 'https://arxiv.org/abs/2111.14562',
                         'file': 'portbench/configs/instaordernet_o_d2.json',
                         'reduced': [], 'why': 'both directions'})
    b['workloads'].append({'name': 'o_d2.dense', 'config':
                           'instaordernet_o_d2', 'traffic': 'offline_dense',
                           'chips': 1, 'why': 'dense scenes'})
    b['end_to_end'][0]['workloads'].append('o_d2.dense')
    b['per_layer'].append({'name': 'step_mfu.dense', 'unit': '%',
                           'better': 'higher', 'source': 'host_clock',
                           'layer': 'serving.megastep', 'moves':
                           'pairs_per_s', 'workloads': ['o_d2.dense']})
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(b))
    for p, data in before.items():
        assert p.read_bytes() == data, p
    h = harness.load_module(dst / 'harness.py', 'portbench_copy_harness')
    wl, config, mix2, limits = h.cell(b, 'o_d2.dense')
    assert config['directions'] == 2 and mix2['instances'] == 16
    assert callable(h.driver(mix2['driver']).readings)
    assert [m['name'] for m in h.cell_metrics(b, 'o_d2.dense',
                                              'per_layer')] == ['step_mfu.dense']
    rec = {'window_s': 1.0, 'chips': 1, 'useful_flops': 989e12,
           'config': config}
    assert h.reader('step_mfu.dense').read(rec) == pytest.approx(100.0)
