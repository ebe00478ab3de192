"""Zoo row i's loss denominators under a process group: on two gloo ranks
(one OS process each, ``tests/torch_fixtures/dist.py``) every loss is the
rank's share, and the shares add up to the loss of the whole batch.

``forward_train`` in float64 of the narrow HTC, SCNet, Mask Scoring R-CNN,
PointRend and YOLACT of the row's CPU tests (BatchNorm in train mode,
synced), each against the same code on the whole batch in one process,
rtol 1e-5 (the sums run in other orders). The one-process losses are
held against tpudet's by ``test_torch_htc_scnet.py``,
``test_torch_ms_rcnn_point_rend.py`` and ``test_torch_yolact.py``. Image
0 holds 4 gts and the semantic map's out-of-class labels, image 1 two gts,
so the halves differ. A mean over the batch (HTC's and SCNet's semantic
CE, SCNet's multi-label BCE) taken over the rank's own images alone would
give each rank the whole loss: twice it, summed. PointRend's hashed
training points are keyed by the image's row in the global batch, as in
tpudet's SPMD batch: keyed by the row in the rank's shard, rank 1's
points would be other points.
"""
import numpy as np
import pytest

from tpudet_torch.models.builder import build_detector
from tpudet_torch.utils.flax_import import random_flax_variables

from . import test_torch_htc_scnet as htc_scnet
from . import test_torch_ms_rcnn_point_rend as ms_point_rend
from . import test_torch_yolact as yolact
from .torch_fixtures.dist import Ranks, forward_train_job, forward_trains_job
from . import torch_fixtures  # noqa: F401  (one intra-op thread)

WORLD, RTOL = 2, 1e-5
# each model's losses that must be there and above 0
KEYS = {
    'htc': ['loss_semantic_seg', 'loss_mask_s0', 'loss_cls_s2'],
    'scnet': ['loss_semantic_seg', 'loss_glbctx', 'loss_mask'],
    'ms_rcnn': ['loss_mask', 'loss_mask_iou'],
    'point_rend': ['loss_mask', 'loss_point'],
    'yolact': ['loss_mask', 'loss_segm', 'loss_cls'],
}


def _cfg(name):
    if name in ('htc', 'scnet'):
        return htc_scnet.zoo_cfg(name)
    if name == 'yolact':
        return yolact.yolact_cfg()
    return ms_point_rend.zoo_cfg(name)


def _batch(name):
    if name == 'yolact':
        return yolact.batch(23)
    return htc_scnet.mask_batch(23, semantic=name in ('htc', 'scnet'))


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    models = {}
    for seed, name in enumerate(KEYS):
        cfg = _cfg(name)
        models[name] = (cfg, random_flax_variables(build_detector(cfg),
                                                   seed=seed + 3),
                        _batch(name))
    ranks = Ranks(forward_trains_job, WORLD,
                  tmp_path_factory.mktemp('zoo_i'), models)
    whole = {name: forward_train_job(0, 1, *m) for name, m in models.items()}
    return whole, ranks.join()


@pytest.mark.parametrize('name', list(KEYS))
def test_the_ranks_shares_add_up_to_the_whole_batchs_loss(runs, name):
    whole, ranks = runs
    ref = whole[name]
    got = {k: sum(r[name][k] for r in ranks) for k in ranks[0][name]}
    assert set(got) == set(ref) and set(KEYS[name]) <= set(ref)
    assert all(ref[k] > 0 for k in KEYS[name])
    for k, v in ref.items():
        np.testing.assert_allclose(got[k], v, rtol=RTOL, err_msg=k)
