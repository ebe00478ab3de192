"""FSAF (``FSAFHead``, the TBLR coder) and FreeAnchor
(``FreeAnchorRetinaHead``) in tpudet_torch against tpudet, on the CPU.

The detectors are tpudet's test configs (``tests/test_models/
test_{fsaf,free_anchor}.py``: ResNet-18, a 32-channel FPN, one stacked
conv, FreeAnchor's bags of 8) with the shipped configs' caps, at 128 px,
batches of 2, random weights (``test_torch_fcos_family.py``'s helpers and
tolerances: pred maps 1e-4 of each map's largest value; the loss terms
and their gradients on tpudet's maps rtol 1e-5; the keeps of
``get_bboxes`` equal, end to end one-to-one; the float64 step's losses
rtol 1e-4 and state within 5e-3 of its change, from tpudet's init).

- ``TBLRBBoxCoder``: encode and decode (clipped to per-image shapes or
  not) equal to tpudet's within 1e-6 relative, 1e-4 px;
- FreeAnchor's (anchor, class) probability taken by a scatter-max (no (G,
  A, C) product): equal to tpudet's product-max, value for value;
- ties in FreeAnchor's bags: gts that overlap no anchor, or overlap a
  symmetric set of anchors alike, put equal IoUs across the top-k's
  border; the port's bags (a stable sort) are ``lax.top_k``'s, index for
  index, and the loss is tpudet's (rtol 1e-5) on those gts;
- FSAF's level selection (an ``argmin`` of per-level mean losses) and its
  least-area contest run in fp32 on both sides from maps that agree to a
  few fp32 ulps; the float64 step takes them on the same fp32-rounded
  maps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet.core import bbox as jbbox
from tpudet_torch.core import bbox as tbbox
from tpudet_torch.core.nms import topk_scores
from tpudet_torch.models.builder import build_detector
from tpudet_torch.models.dense_heads.free_anchor_retina_head import \
    FreeAnchorRetinaHead
from tpudet_torch.models.detectors.single_stage import FSAF, RetinaNet

from .test_models.test_free_anchor import free_anchor_cfg
from .test_models.test_fsaf import fsaf_cfg
from .test_torch_atss_gfl import (assert_step_matches, float64_step, gts,
                                  step_batch)
from .test_torch_fcos_family import (NUM_CLASSES,
                                     assert_get_bboxes_match,
                                     assert_loss_and_map_gradients,
                                     assert_maps_close, detector_pair,
                                     shipped)
from . import torch_fixtures  # noqa: F401  (one intra-op thread)

MODELS = {
    'fsaf': (lambda: shipped(fsaf_cfg(NUM_CLASSES)), FSAF,
             ('loss_cls', 'loss_bbox')),
    'free_anchor': (lambda: shipped(free_anchor_cfg(NUM_CLASSES)), RetinaNet,
                    ('positive_bag_loss', 'negative_bag_loss')),
}


@pytest.fixture(scope='module', params=list(MODELS))
def pair(request):
    return (request.param,) + detector_pair(MODELS[request.param][0](), 50)


def test_pred_maps_match_tpudet(pair):
    kind, _, _, det, _, ref, got = pair
    assert type(det.model) is MODELS[kind][1]
    assert [tuple(c.shape[1:3]) for c in got[0]] == [(16, 16), (8, 8),
                                                     (4, 4), (2, 2), (1, 1)]
    assert_maps_close(got, ref)


def test_loss_and_gradients_match_tpudet(pair):
    kind, jmodel, _, det, _, ref, _ = pair
    keys = MODELS[kind][2]
    tl = assert_loss_and_map_gradients(jmodel, det.model, ref, *gts(51),
                                       keys)
    assert all(float(tl[k]) > 0 for k in keys)
    if kind == 'fsaf':
        assert float(tl['num_pos']) > 0


def test_loss_without_gts_matches_tpudet(pair):
    kind, jmodel, _, det, _, ref, _ = pair
    boxes, labels, valid = gts(52)
    valid[:] = False
    assert_loss_and_map_gradients(jmodel, det.model, ref, boxes, labels,
                                  valid, MODELS[kind][2][1:])


@pytest.mark.parametrize('rescale', [False, True])
def test_get_bboxes_matches_tpudet(pair, rescale):
    _, jmodel, _, det, _, ref, got = pair
    assert_get_bboxes_match(jmodel, det.model, ref, got, rescale, 1)


@pytest.mark.parametrize('kind', list(MODELS))
def test_a_train_step_matches_tpudet_in_float64(kind):
    state0, jstate, jm, tstate, tm, _ = float64_step(MODELS[kind][0](),
                                                     step_batch(53))
    assert_step_matches(state0, jstate, jm, tstate, tm, MODELS[kind][2])


# the coder

@pytest.mark.parametrize('clip', [False, True])
def test_tblr_coder_matches_tpudet(clip):
    rng = np.random.RandomState(9)
    xy = rng.uniform(0, 100, (2, 30, 2))
    anchors = np.concatenate([xy, xy + rng.uniform(4, 40, (2, 30, 2))],
                             -1).astype(np.float32)
    xy = xy + rng.uniform(-20, 20, (2, 30, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(1, 60, (2, 30, 2))],
                           -1).astype(np.float32)
    jc, tc = jbbox.TBLRBBoxCoder(normalizer=4.0), tbbox.TBLRBBoxCoder(4.0)
    enc = tc.encode(torch.from_numpy(anchors), torch.from_numpy(boxes))
    np.testing.assert_allclose(enc.numpy(), np.asarray(jc.encode(
        jnp.asarray(anchors), jnp.asarray(boxes))), rtol=1e-6, atol=1e-6)
    hw = np.array([[90.], [120.]], np.float32)
    shape = ((torch.from_numpy(hw), torch.from_numpy(hw + 10)) if clip
             else None)
    dec = tc.decode(torch.from_numpy(anchors), enc, max_shape=shape)
    ref = jc.decode(jnp.asarray(anchors), jnp.asarray(enc.numpy()),
                    max_shape=(jnp.asarray(hw), jnp.asarray(hw + 10))
                    if clip else None)
    np.testing.assert_allclose(dec.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-4)
    if not clip:  # decode inverts encode
        np.testing.assert_allclose(dec.numpy(), boxes, atol=1e-3)


# FreeAnchor's pieces

def test_image_box_prob_by_scatter_equals_the_product_max():
    """The (A, C) max over same-class gts of tpudet's (G, A, C) product,
    as the port takes it: a scatter-max of each gt's row into its class."""
    rng = np.random.RandomState(10)
    g, a, c = 12, 300, 7
    obj = np.where(rng.rand(g, a) < 0.3, rng.rand(g, a), 0.)
    labels = rng.randint(0, c, g)
    valid = rng.rand(g) < 0.8
    obj = np.where(valid[:, None], obj, 0.)
    onehot = np.eye(c)[labels] * valid[:, None]
    ref = (obj[:, :, None] * onehot[:, None, :]).max(0)
    got = torch.zeros(c, a, dtype=torch.float64).scatter_reduce_(
        0, torch.from_numpy(labels)[:, None].expand(g, a),
        torch.from_numpy(obj), 'amax').t()
    np.testing.assert_array_equal(got.numpy(), ref)


def tie_gts():
    """Gts whose IoUs with the anchors of a 64-px image tie across the top
    8: one far outside (IoU 0 with every anchor), tiny ones between anchor
    centres, and squares centred on a cell corner (their IoUs with the 4
    cells around the corner are equal)."""
    boxes = np.array([[[200., 200., 230., 230.],   # outside: all IoUs 0
                       [15., 15., 17., 17.],       # tiny, between centres
                       [8., 8., 24., 24.],         # on the corner (16, 16)
                       [20., 4., 44., 28.],        # on the corner (32, 16)
                       [0., 0., 0., 0.]]], np.float32)
    boxes = np.concatenate([boxes, boxes[:, [3, 2, 1, 0, 4]]])
    labels = np.array([[1, 2, 0, 3, 0]] * 2, np.int32)
    valid = np.array([[True] * 4 + [False]] * 2)
    return boxes, labels, valid


def test_free_anchor_bags_take_lax_top_k_ties():
    """The bags of the tie case, index for index, and the ties are real:
    the 8th and 9th IoU of at least two gts' rows are equal."""
    cfg = free_anchor_cfg(NUM_CLASSES)
    with torch.device('meta'):
        head = build_detector(cfg).bbox_head
    assert isinstance(head, FreeAnchorRetinaHead)
    sizes = [(8, 8), (4, 4), (2, 2), (1, 1), (1, 1)]
    anchors = np.concatenate(head.anchor_generator.grid_anchors(sizes))
    boxes, _, valid = tie_gts()
    for b in range(2):
        qual = np.asarray(jbbox.bbox_overlaps(jnp.asarray(boxes[b]),
                                              jnp.asarray(anchors)))
        _, ref = jax.lax.top_k(jnp.asarray(qual), 8)
        _, got = topk_scores(torch.from_numpy(qual), 8)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        srt = -np.sort(-qual[valid[b]], axis=1)
        assert (srt[:, 7] == srt[:, 8]).sum() >= 2


def test_free_anchor_loss_on_ties_matches_tpudet():
    jmodel, _, det, _, ref, _ = detector_pair(
        shipped(dict(free_anchor_cfg(NUM_CLASSES))), 54)
    boxes, labels, valid = tie_gts()
    # the maps are 128 px: the tie gts scaled to its grid
    tl = assert_loss_and_map_gradients(jmodel, det.model, ref, boxes * 2,
                                       labels, valid,
                                       MODELS['free_anchor'][2])
    assert float(tl['positive_bag_loss']) > 0
