"""Double-Head R-CNN, Dynamic R-CNN, Grid R-CNN, PISA's Faster R-CNN and
the Cascade RPN Faster R-CNN under a process group: on two gloo ranks (one
OS process each, ``tests/torch_fixtures/dist.py``) every loss is the
rank's share, and the shares add up to the loss of the whole batch.

``forward_train`` in float64 of the narrow detectors of
``test_torch_{double_dynamic_pisa,grid_rcnn,cascade_rpn}.py`` (BatchNorm
in train mode, synced: the Double head's BatchNorms normalize over every
rank's roi slots), each against the same code on the whole batch in one
process, rtol 1e-5 (the sums run in other orders). The one-process losses
are held against tpudet's by those files. Image 0 holds 4 gts, image 1
two, so the halves differ. Every statistic is the whole batch's: the RoI
heads' sampled and positive counts, Dynamic R-CNN's threshold (a mean over
every rank's images) and its beta (the 10 B-th smallest error over every
rank's positives; ``dynamic_beta``, a share as every entry, adds up to
it),
PISA's rank set (gathered), its ratio and CARL's count and weight sum, the
grid loss's positives, and the Cascade RPN's region, sampled and positive
counts.
"""
import numpy as np
import pytest

from tpudet_torch.models.builder import build_detector
from tpudet_torch.utils.flax_import import random_flax_variables

from . import test_torch_cascade_rpn as cascade_rpn
from . import test_torch_double_dynamic_pisa as rcnn
from . import test_torch_grid_rcnn as grid
from .test_torch_atss_gfl import step_batch
from .torch_fixtures.dist import Ranks, forward_train_job, forward_trains_job
from . import torch_fixtures  # noqa: F401  (one intra-op thread)

WORLD, RTOL = 2, 1e-5


def grid_cfg():
    c = grid.cfg(10)
    c['neck'] = dict(c['neck'], out_channels=32)
    c['rpn_head'] = dict(c['rpn_head'], in_channels=32, feat_channels=32)
    c['roi_head'] = dict(c['roi_head'], in_channels=32, num_samples=16,
                         max_num_grid=4)
    return c


CFGS = {
    'double_head': lambda: rcnn.faster_cfg('DoubleHeadRoIHead',
                                           'DoubleHeadRCNN', 8),
    'dynamic': lambda: rcnn.faster_cfg('DynamicRoIHead', 'DynamicRCNN'),
    'pisa': lambda: rcnn.faster_cfg('PISARoIHead'),
    'grid': grid_cfg,
    'cascade_rpn': lambda: cascade_rpn.cfg(levels=2, channels=32),
}
# each model's losses that must be there and above 0
KEYS = {
    'double_head': rcnn.ROI_KEYS + ('loss_rpn_cls',),
    'dynamic': rcnn.ROI_KEYS + ('loss_rpn_cls',),
    'pisa': rcnn.PISA_KEYS + ('loss_rpn_cls',),
    'grid': ('loss_cls', 'loss_grid', 'loss_rpn_cls'),
    'cascade_rpn': cascade_rpn.KEYS + ('loss_cls',),
}


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    models = {}
    for seed, name in enumerate(CFGS):
        cfg = CFGS[name]()
        models[name] = (cfg, random_flax_variables(build_detector(cfg),
                                                   seed=seed + 60),
                        step_batch(61))
    ranks = Ranks(forward_trains_job, WORLD,
                  tmp_path_factory.mktemp('zoo_j2b'), models)
    whole = {name: forward_train_job(0, 1, *m) for name, m in models.items()}
    return whole, ranks.join()


@pytest.mark.parametrize('name', list(CFGS))
def test_the_ranks_shares_add_up_to_the_whole_batchs_loss(runs, name):
    whole, ranks = runs
    ref = whole[name]
    got = {k: sum(r[name][k] for r in ranks) for k in ranks[0][name]}
    assert set(got) == set(ref) and set(KEYS[name]) <= set(ref)
    assert all(ref[k] > 0 for k in KEYS[name])
    for k, v in ref.items():
        np.testing.assert_allclose(got[k], v, rtol=RTOL, err_msg=k)
