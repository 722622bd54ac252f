"""The sequential siamese mode (fused_siamese: False: two passes, the
second starting from the running statistics the first returned) and
the eval-mode loss of each ported algorithm against the JAX package's on
the CPU, with test_torch_train_step.py's nets, batches, ReLU-branch
sharing and bars."""

import numpy as np
import pytest

from instaorder_tpu.models import resnet as jresnet
from instaorder_tpu.train import algos as JA

from instaorder_tpu_torch import convert
from instaorder_tpu_torch.train import algos as TA
from instaorder_tpu_torch.train import step as TST

from test_torch_train_step import (  # noqa: F401 (a fixture)
    CASES, NET, check_loss_grads_stats, jax_net, make_batch,
    one_torch_thread, to_port)


@pytest.fixture(scope='module')
def nets():
    return {str(c): jax_net(i, c) for i, c in enumerate((2, 3, 4, [2, 3]))}


@pytest.mark.parametrize('case', CASES, ids=[c[0] for c in CASES])
def test_loss_grads_stats_sequential(nets, case):
    check_loss_grads_stats(nets, case, fused=False)


@pytest.mark.parametrize('case', [CASES[0], CASES[4]], ids=['o', 'od'])
def test_eval_loss(nets, case):
    """train=False: eval-mode BatchNorm, the stats returned as given
    (the eval step)."""
    _, algo, classes, hyper = case
    params, stats, cfg = nets[str(classes)]
    batch = make_batch(4, 9, classes)
    wl, _ = JA.make_loss(algo, jresnet.apply, cfg, hyper)(
        params, stats, batch, False)
    ev = TST.build_eval_step(TA.make_loss(algo, NET, cfg, hyper))
    logs = ev(convert.to_torch(params), convert.to_torch(stats),
              to_port(batch))
    np.testing.assert_allclose(float(logs['loss']), float(wl), rtol=1e-5)
