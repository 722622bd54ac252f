"""Each one-card cell run once on the card through its command (marked
`cuda`; skips without a card, decided inside the test)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.cuda
@pytest.mark.parametrize('workload', ['o.offline', 'od.image'])
def test_cell_runs_correct_on_the_card(workload):
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    out = subprocess.run(
        [sys.executable, 'portbench/run.py', '--workload', workload,
         '--seed', str(2 ** 31 + 3), '--seconds', '3', '--trace', '0'],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res['correct'], res['checks']
    assert res['device']['platform'] == 'gpu'


def test_no_result_without_a_card(tmp_path):
    """Without the cell's cards the command exits non-zero and prints no
    result."""
    import torch
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    out = subprocess.run(
        [sys.executable, 'portbench/run.py', '--workload', 'o.offline',
         '--seed', '1', '--seconds', '1', '--trace', '0'],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ''


def test_no_result_without_the_program(tmp_path):
    """In a directory holding only BENCHMARK.json and portbench/, the
    command exits non-zero and prints no result."""
    import shutil
    shutil.copy(ROOT / 'BENCHMARK.json', tmp_path)
    shutil.copytree(ROOT / 'portbench', tmp_path / 'portbench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    out = subprocess.run(
        [sys.executable, 'portbench/run.py', '--workload', 'o.offline',
         '--seed', '1', '--seconds', '1', '--trace', '0'],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ''
