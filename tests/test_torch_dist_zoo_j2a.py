"""RepPoints, SABL RetinaNet, SABL Faster R-CNN, GA RetinaNet and the GA
Faster R-CNN under a process group: on two gloo ranks (one OS process
each, ``tests/torch_fixtures/dist.py``) every loss is the rank's share,
and the shares add up to the loss of the whole batch.

``forward_train`` (the single-stage detectors' head loss of their
forward) in float64 of the narrow detectors of
``test_torch_{reppoints,sabl,guided_anchor}.py`` (BatchNorm in train
mode, synced), each against the same code on the whole batch in one
process, rtol 1e-5 (the sums run in other orders). The one-process losses
are held against tpudet's by those files. Image 0 holds 4 gts, image 1
two, so the halves differ. Every normalizer is a count over the whole
batch: RepPoints' two stages' positives, SABL's positives (and the RoI
head's sampled rois and positives), Guided Anchoring's location factor
``b * cells / 200`` (``b`` the images of every rank), its shape loss's
capped fg + bg count, its positives, and the GA-RPN's sample and its
positives.
"""
import numpy as np
import pytest

from tpudet_torch.models.builder import build_detector
from tpudet_torch.utils.flax_import import random_flax_variables

from . import test_torch_guided_anchor as guided_anchor
from . import test_torch_reppoints as reppoints
from . import test_torch_sabl as sabl
from .test_torch_atss_gfl import step_batch
from .torch_fixtures.dist import Ranks, forward_train_job, forward_trains_job
from . import torch_fixtures  # noqa: F401  (one intra-op thread)

WORLD, RTOL = 2, 1e-5
CFGS = {
    'reppoints': lambda: reppoints.cfg(3),
    'sabl_retinanet': sabl.retina_cfg,
    'sabl_faster_rcnn': sabl.faster_cfg,
    'ga_retinanet': guided_anchor.retina_cfg,
    'ga_faster_rcnn': guided_anchor.faster_cfg,
}
# each model's losses that must be there and above 0
KEYS = {
    'reppoints': reppoints.KEYS,
    'sabl_retinanet': sabl.KEYS,
    'sabl_faster_rcnn': sabl.ROI_KEYS + ('loss_rpn_cls',),
    'ga_retinanet': guided_anchor.KEYS,
    'ga_faster_rcnn': guided_anchor.RPN_KEYS + ('loss_cls', 'loss_bbox'),
}


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    models = {}
    for seed, name in enumerate(CFGS):
        cfg = CFGS[name]()
        models[name] = (cfg, random_flax_variables(build_detector(cfg),
                                                   seed=seed + 90),
                        step_batch(91))
    ranks = Ranks(forward_trains_job, WORLD,
                  tmp_path_factory.mktemp('zoo_j2a'), models)
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
