"""The port's make_int8_predictor (the fully quantized int8c model, its
default kernel set; plain versions on the CPU) against the JAX package's
XLA int8 oracle, on JAX's fold and calibration scales. Bars and
helpers: tests/test_torch_pipeline_factories.py."""

import pytest

from instaorder_tpu.eval import pipeline as JPL

from test_torch_pipeline import scene
from test_torch_pipeline_factories import (KW, _calib, _nets, hold_factory,
                                           same_fold_and_scales)

from instaorder_tpu_torch.eval import pipeline as TPL
import torch_threads  # noqa: F401 (the suite's torch thread cap)


@pytest.mark.parametrize('method', ['InstaOrderNet_o', 'InstaOrderNet_od'])
def test_int8_predictor_matches_jax(method, monkeypatch):
    """The port's int8c kernels' plain versions against JAX's XLA int8
    oracle (the kernels equal it bit for bit, tests/test_torch_int8c.py)."""
    j, t = _nets(method)
    image, masks, bboxes = scene(24, n=5)
    calib = _calib(image, masks, bboxes)
    same_fold_and_scales(monkeypatch, j, t, calib)
    jp = JPL.make_int8_predictor(*j[:3], method, calib, use_pallas=False,
                                 **KW)
    tp = TPL.make_int8_predictor(*t[:3], method, calib, device='cpu', **KW)
    hold_factory(jp, tp, image, masks, bboxes, bar=1e-5, exact=True,
                 dual=method != 'InstaOrderNet_o', e2e=False)
