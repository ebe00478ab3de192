"""PAA's loss denominators under a process group: on two gloo ranks (one
OS process each, ``tests/torch_fixtures/dist.py``) every loss is the
rank's share, and the shares add up to the loss of the whole batch.

- ``PAAHead`` (``num_pos``, the images, the IoU targets' sum) against
  tpudet's head on the whole batch, fp32, rtol 1e-5 (the head's own
  tests' tolerance), on random pred maps; image 0 holds 6 gts, image 1
  two, so the halves differ; ``num_gts`` is a share too.
- The PAA detector's ``forward_train`` in float64 against the same code
  on the whole batch in one process, rtol 1e-5.
- Each rank alone, dividing by its own counts, and the two averaged miss
  tpudet's global loss by far more than the tolerance.
"""
import numpy as np
import pytest

from tpudet_torch.models.builder import build_detector
from tpudet_torch.utils.flax_import import random_flax_variables

from .test_models.test_paa import paa_cfg
from .test_torch_atss_gfl import step_batch
from .test_torch_dist_atss import CH, IMG, NUM_CLASSES, _maps
from .test_torch_dist_losses import tpudet_head_losses
from .test_torch_rpn_head import gts
from .torch_fixtures.dist import Ranks, forward_train_job, head_losses, \
    losses_job
from . import torch_fixtures  # noqa: F401  (one intra-op thread)

WORLD, RTOL = 2, 1e-5


def head_cases():
    rng = np.random.RandomState(1)
    boxes, labels, valid = gts(3, size=IMG)
    head = dict(type='PAAHead', num_classes=NUM_CLASSES, in_channels=CH,
                feat_channels=CH, stacked_convs=1)
    return {'paa': (head, 'loss', (
        (_maps(rng, NUM_CLASSES, 2.0), _maps(rng, 4, 0.5), _maps(rng, 1)),
        boxes, labels, valid))}


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    cases = head_cases()
    cfg = paa_cfg(NUM_CLASSES)
    variables = random_flax_variables(build_detector(cfg), seed=8)
    batch = step_batch(9)
    ranks = Ranks(losses_job, WORLD, tmp_path_factory.mktemp('paa'), cases,
                  cfg, variables, batch)
    ref = tpudet_head_losses(cases)
    return cases, ref, ranks.join(), (cfg, variables, batch)


def _summed(shares):
    return {k: sum(s[k] for s in shares) for k in shares[0]}


def test_the_ranks_shares_add_up_to_tpudets_loss(runs):
    _, ref, ranks, _ = runs
    got = _summed([heads['paa'] for heads, _ in ranks])
    assert set(got) == set(ref['paa'])
    for k, v in ref['paa'].items():
        np.testing.assert_allclose(got[k], v, rtol=RTOL, err_msg=k)
    assert all(v > 0 for k, v in ref['paa'].items() if 'loss' in k)


def test_per_rank_denominators_would_miss_it(runs):
    cases, ref, _, _ = runs
    alone = [head_losses(cases, r, WORLD)['paa'] for r in range(WORLD)]
    mean = {k: np.mean([a[k] for a in alone]) for k in alone[0]}
    worst = max(abs(mean[k] - v) / abs(v) for k, v in ref['paa'].items()
                if 'loss' in k and v)
    assert worst > 100 * RTOL


def test_paa_forward_train_shares_add_up(runs):
    cfg, variables, batch = runs[3]
    whole = forward_train_job(0, 1, cfg, variables, batch)
    got = _summed([f for _, f in runs[2]])
    assert set(got) == set(whole) and whole['loss_iou'] > 0
    for k, v in whole.items():
        np.testing.assert_allclose(got[k], v, rtol=RTOL, err_msg=k)
