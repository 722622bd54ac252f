"""The port's make_v2_predictor (the boundary-int8 model, its default
kernel set; plain versions on the CPU) against the JAX package's with
its kernels in interpret mode, on JAX's fold and calibration scales.
Bars and helpers: tests/test_torch_pipeline_factories.py."""

import pytest

from instaorder_tpu.eval import pipeline as JPL

from test_torch_pipeline import scene
from test_torch_pipeline_factories import (KW, _calib, _nets, hold_factory,
                                           interpret,  # noqa: F401
                                           same_fold_and_scales)

from instaorder_tpu_torch.eval import pipeline as TPL
import torch_threads  # noqa: F401 (the suite's torch thread cap)


@pytest.mark.parametrize('method', ['InstaOrderNet_o', 'InstaOrderNet_od'])
def test_v2_predictor_matches_jax(method, interpret, monkeypatch):
    j, t = _nets(method)
    image, masks, bboxes = scene(23, n=5)
    calib = _calib(image, masks, bboxes)
    same_fold_and_scales(monkeypatch, j, t, calib)
    jp = JPL.make_v2_predictor(*j[:3], method, calib, **KW)
    tp = TPL.make_v2_predictor(*t[:3], method, calib, device='cpu', **KW)
    hold_factory(jp, tp, image, masks, bboxes, bar=0.02, exact=False,
                 dual=method != 'InstaOrderNet_o')
