"""The port's make_folded_predictor(dtype=bf16) with the bf16 kernels
`identity,down,stem` (plain versions on the CPU) against the JAX
package's with the same kernels in interpret mode. Bars and helpers:
tests/test_torch_pipeline_factories.py."""

import jax.numpy as jnp
import pytest
import torch

from instaorder_tpu.eval import pipeline as JPL

from test_torch_pipeline import scene
from test_torch_pipeline_factories import (KFEATS, KW, _nets, hold_factory,
                                           interpret)  # noqa: F401

from instaorder_tpu_torch.eval import pipeline as TPL
import torch_threads  # noqa: F401 (the suite's torch thread cap)


@pytest.mark.parametrize('method', ['InstaOrderNet_o', 'InstaOrderNet_od'])
def test_folded_bf16_predictor_matches_jax(method, interpret):
    j, t = _nets(method)
    jp = JPL.make_folded_predictor(*j[:3], method, dtype=jnp.bfloat16,
                                   use_pallas=KFEATS, **KW)
    tp = TPL.make_folded_predictor(*t[:3], method, dtype=torch.bfloat16,
                                   use_pallas=KFEATS, device='cpu', **KW)
    hold_factory(jp, tp, *scene(22, n=5), bar=0.02, exact=False,
                 dual=method != 'InstaOrderNet_o')
