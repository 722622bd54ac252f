"""A run with the timed path broken underneath comes out not correct:
each fault the cell can have, planted in the program (tests/faults.py),
the run driven on the CPU at test size past the harness's look for a
card. A sound run at the same size comes out correct."""

import pytest

from portbench.tests import small

F = 'portbench.tests.faults:'


def _protect(monkeypatch):
    """Restore what the single-process plants patch."""
    from instaorder_tpu_torch import serving
    from instaorder_tpu_torch.eval import pipeline
    from instaorder_tpu_torch.models import folding, quantize
    monkeypatch.setattr(serving, 'megastep', serving.megastep)
    monkeypatch.setattr(folding, '_apply_trunk', folding._apply_trunk)
    monkeypatch.setattr(quantize, 'quantize_folded_v2',
                        quantize.quantize_folded_v2)
    monkeypatch.setattr(pipeline, 'fold_resnet', pipeline.fold_resnet)
    monkeypatch.setattr(pipeline.OrderPredictor, 'pair_outputs',
                        pipeline.OrderPredictor.pair_outputs)


@pytest.mark.parametrize('workload', ['o.offline', 'od.image', 'od.train4'])
def test_sound_run_is_correct(workload):
    res, out = small.run(workload)
    assert res['correct'], res['checks']
    assert not out.get('forbidden')


@pytest.mark.parametrize('workload,fault', [
    ('o.offline', 'plant_offline_altered'),
    ('o.offline', 'plant_offline_half'),
    ('o.offline', 'plant_offline_block'),
    ('od.image', 'plant_image_block'),
    ('od.image', 'plant_image_altered'),
    ('od.image', 'plant_image_half'),
])
def test_fault_is_caught(monkeypatch, workload, fault):
    _protect(monkeypatch)
    res, _ = small.run(workload, plant=F + fault)
    assert not res['correct'], res['checks']


@pytest.mark.parametrize('fault', ['plant_train_unchanged', 'plant_train_half',
                                   'plant_train_no_exchange',
                                   'plant_train_altered'])
def test_train_fault_is_caught(fault):
    res, _ = small.run('od.train4', plant=F + fault)
    assert not res['correct'], res['checks']


def test_rank_with_jax_loaded_gives_no_result(capsys):
    """A rank that has JAX loaded once its window has closed refuses the
    run: no result line, exit code 2, the module named."""
    from portbench import run
    res, out = small.run('od.train4', plant=F + 'plant_train_loads_jax')
    assert out['forbidden'] == ['jax']
    capsys.readouterr()
    assert run.report(res, out) == 2
    cap = capsys.readouterr()
    assert cap.out == ''
    assert "'jax'" in cap.err
