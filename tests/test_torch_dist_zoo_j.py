"""Zoo row j's one-stage detectors under a process group: on two gloo
ranks (one OS process each, ``tests/torch_fixtures/dist.py``) every loss
is the rank's share, and the shares add up to the loss of the whole
batch.

``loss(model(img))`` in float64 of the narrow FCOS, NAS-FCOS, FoveaBox,
AutoAssign, FSAF, FreeAnchor, YOLOF and NAS-FPN RetinaNet of the row's
CPU tests (BatchNorm in train mode, synced), each against the same code on
the whole batch in one process, rtol 1e-5 (the sums run in other
orders). The one-process losses are held against tpudet's by
``test_torch_{fcos_family,nasfcos,fsaf_free_anchor,yolof_nas_fpn}.py``.
Image 0 holds 4 gts, image 1 two, so the halves differ. Every head
normalizes by counts over the whole batch (positives, gts, the
centerness targets' sum, AutoAssign's prior sum, FoveaBox's positives
plus images, FSAF's kept positives or its negatives): a count over the
rank's own image would give each rank a share of another size.
"""
import numpy as np
import pytest

from tpudet_torch.models.builder import build_detector
from tpudet_torch.utils.flax_import import random_flax_variables

from . import test_torch_fcos_family as fcos_family
from . import test_torch_fsaf_free_anchor as fsaf_free_anchor
from . import test_torch_nasfcos as nasfcos
from . import test_torch_yolof_nas_fpn as yolof_nas_fpn
from .test_torch_atss_gfl import step_batch
from .torch_fixtures.dist import Ranks, forward_train_job, forward_trains_job
from . import torch_fixtures  # noqa: F401  (one intra-op thread)

WORLD, RTOL = 2, 1e-5
CFGS = {
    'fcos': fcos_family.MODELS['fcos'][0],
    'nasfcos': nasfcos.cfg,
    'fovea': fcos_family.MODELS['fovea'][0],
    'autoassign': fcos_family.MODELS['autoassign'][0],
    'fsaf': fsaf_free_anchor.MODELS['fsaf'][0],
    'free_anchor': fsaf_free_anchor.MODELS['free_anchor'][0],
    'yolof': yolof_nas_fpn.MODELS['yolof'][0],
    'nas_fpn': yolof_nas_fpn.MODELS['nas_fpn'][0],
}
# each model's losses that must be there and above 0
KEYS = {
    'fcos': ['loss_cls', 'loss_bbox', 'loss_centerness'],
    'nasfcos': ['loss_cls', 'loss_bbox', 'loss_centerness'],
    'fovea': ['loss_cls', 'loss_bbox'],
    'autoassign': ['loss_pos', 'loss_neg', 'loss_center'],
    'fsaf': ['loss_cls', 'loss_bbox', 'num_pos'],
    'free_anchor': ['positive_bag_loss', 'negative_bag_loss'],
    'yolof': ['loss_cls', 'loss_bbox'],
    'nas_fpn': ['loss_cls', 'loss_bbox'],
}


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    models = {}
    for seed, name in enumerate(CFGS):
        cfg = CFGS[name]()
        models[name] = (cfg, random_flax_variables(build_detector(cfg),
                                                   seed=seed + 70),
                        step_batch(71))
    ranks = Ranks(forward_trains_job, WORLD,
                  tmp_path_factory.mktemp('zoo_j'), models)
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
