"""The ATSS family's loss denominators under a process group: on two gloo
ranks (one OS process each, ``tests/torch_fixtures/dist.py``) every loss
is the rank's share, and the shares add up to the loss of the whole batch.

- ``ATSSHead`` (``num_pos``, the centerness weights' sum), ``GFLHead``
  (``num_pos``, the DFL and GIoU weights' sum) and ``VFNetHead``
  (``num_pos``, each GIoU's IoU weights' sum) against tpudet's heads on
  the whole batch, fp32, rtol 1e-5 (the heads' own tests' tolerance), on
  random pred maps; image 0 holds 6 gts, image 1 two, so the halves
  differ; ``num_gts`` is a share too.
- LD's ``forward_train`` in float64 (``loss_ld`` a plain sum over the
  positives, the teacher frozen) against the same code on the whole batch
  in one process, rtol 1e-5.
- Each rank alone, dividing by its own counts, and the two averaged miss
  tpudet's global loss by far more than the tolerance.
"""
import numpy as np
import pytest

from tpudet_torch.models.builder import build_detector
from tpudet_torch.utils.flax_import import random_flax_variables

from .test_torch_atss_gfl import step_batch
from .test_torch_dist_losses import tpudet_head_losses
from .test_torch_ld import ld_cfg  # noqa: F401  (a fixture)
from .test_torch_rpn_head import gts
from .torch_fixtures.dist import Ranks, forward_train_job, head_losses, \
    losses_job
from . import torch_fixtures  # noqa: F401  (one intra-op thread)

WORLD, RTOL = 2, 1e-5
IMG, NUM_CLASSES, CH = 128, 3, 32
STRIDES = (8, 16, 32, 64, 128)


def _maps(rng, attrib, scale=1.0, positive=False):
    out = []
    for s in STRIDES:
        x = rng.randn(2, IMG // s, IMG // s, attrib) * scale
        out.append((np.exp(x) * 4 * s if positive else x).astype(np.float32))
    return tuple(out)


def head_cases():
    """``{name: (cfg, 'loss', args)}`` for the three heads."""
    rng = np.random.RandomState(0)
    boxes, labels, valid = gts(3, size=IMG)
    head = dict(num_classes=NUM_CLASSES, in_channels=CH, feat_channels=CH,
                stacked_convs=1)
    cls = _maps(rng, NUM_CLASSES, 2.0)
    return {
        'atss': (dict(type='ATSSHead', **head), 'loss', (
            (cls, _maps(rng, 4, 0.5), _maps(rng, 1)), boxes, labels, valid)),
        'gfl': (dict(type='GFLHead', reg_max=8, **head), 'loss', (
            (cls, _maps(rng, 36, 2.0)), boxes, labels, valid)),
        'vfnet': (dict(type='VFNetHead', **head), 'loss', (
            (cls, _maps(rng, 4, 0.3, True), _maps(rng, 4, 0.3, True)),
            boxes, labels, valid)),
    }


@pytest.fixture(scope='module')
def runs(ld_cfg, tmp_path_factory):
    cases = head_cases()
    variables = random_flax_variables(build_detector(ld_cfg), seed=8)
    batch = step_batch(9)
    ranks = Ranks(losses_job, WORLD, tmp_path_factory.mktemp('atss'), cases,
                  ld_cfg, variables, batch)
    ref = tpudet_head_losses(cases)
    return cases, ref, ranks.join(), (ld_cfg, variables, batch)


def _summed(shares):
    return {k: sum(s[k] for s in shares) for k in shares[0]}


@pytest.mark.parametrize('head', ['atss', 'gfl', 'vfnet'])
def test_the_ranks_shares_add_up_to_tpudets_loss(runs, head):
    _, ref, ranks, _ = runs
    got = _summed([heads[head] for heads, _ in ranks])
    assert set(got) == set(ref[head])
    for k, v in ref[head].items():
        np.testing.assert_allclose(got[k], v, rtol=RTOL, err_msg=k)
    assert all(v > 0 for k, v in ref[head].items() if 'loss' in k)


@pytest.mark.parametrize('head', ['atss', 'gfl', 'vfnet'])
def test_per_rank_denominators_would_miss_it(runs, head):
    cases, ref, _, _ = runs
    alone = [head_losses({head: cases[head]}, r, WORLD)[head]
             for r in range(WORLD)]
    mean = {k: np.mean([a[k] for a in alone]) for k in alone[0]}
    worst = max(abs(mean[k] - v) / abs(v) for k, v in ref[head].items()
                if 'loss' in k and v)
    assert worst > 100 * RTOL


def test_ld_forward_train_shares_add_up(runs):
    cfg, variables, batch = runs[3]
    whole = forward_train_job(0, 1, cfg, variables, batch)
    got = _summed([f for _, f in runs[2]])
    assert set(got) == set(whole) and whole['loss_ld'] > 0
    for k, v in whole.items():
        np.testing.assert_allclose(got[k], v, rtol=RTOL, err_msg=k)
