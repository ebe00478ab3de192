"""Guided anchoring (``bounded_iou_loss``, ``FeatureAdaption``,
``GARetinaHead``, ``GARPNHead``, ``GARetinaNet``, the GA Faster R-CNN) in
tpudet_torch against tpudet, on the CPU.

- ``bounded_iou_loss`` (weighted or not, ``reduction='none'`` too) and its
  gradient on random box pairs, a few equal: rtol 1e-5; the target gets
  no gradient;
- ``loc_targets``' centre, ignore and negative maps and their average
  factor equal tpudet's for random gts over all five levels, and for gts
  whose rings overlap (a later gt's ignore ring over an earlier gt's
  centre) and gts on adjacent levels;
- the approx-max-IoU assignment without low-quality matching, in the
  shape loss: held through ``loss`` on tie gts (two copies of one box);
- GA RetinaNet: tpudet's test config (ResNet-18 from C3, a 64-channel FPN,
  two stacked convs) with 5 classes and the shipped caps, at three levels
  (P3-P5: tpudet's jitted forward compiles for seconds a deformable site,
  6 sites here), 128 px, random weights (every leaf drawn: the shapes
  spread, ``conv_offset`` moves the taps pixels off the grid): maps within
  1e-4 of each map's largest |value|; ``loss`` on tpudet's maps in float64
  (the MaxIoU over the guided anchors is a choice on computed values) rtol
  1e-6 and its gradients with respect to the maps; ``get_bboxes`` of
  tpudet's maps, the keeps equal, end to end one-to-one;
- GA-RPN (strides 4-16 of 4-64) in the Faster R-CNN: ``loss`` on tpudet's
  maps in float64 and its gradients (tpudet's fixed sample of 256 an
  image by ``RandomState(11)``); ``get_proposals`` of tpudet's maps with
  300 an image, equal (boxes 1e-3 px, scores 1e-6), the location filter
  dropping cells;
- one float64 train step of GA RetinaNet (P5 alone, one stacked conv)
  and of the GA Faster R-CNN (P2 alone; the RoI head's ReLU inputs moved
  above 0) from the same
  random weights, 2 images of 64 px: the losses and the gradient norm
  rtol 1e-4, the state within 5e-3 of the step's change; the deformable
  sites' gradients in them.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet.models import losses as jlosses
from tpudet.models.builder import build_detector as jax_build_detector
from tpudet.models.builder import build_head as jax_build_head
from tpudet_torch.models import losses as tlosses
from tpudet_torch.models.builder import build_detector
from tpudet_torch.models.dense_heads.guided_anchor_head import (GARetinaHead,
                                                                GARPNHead)
from tpudet_torch.models.detectors.single_stage import GARetinaNet
from tpudet_torch.utils.flax_import import load_flax_variables

from .test_models.test_guided_anchor import ga_retina_cfg
from .test_torch_atss_gfl import assert_step_matches, gts, images
from .test_torch_backbone_neck import random_variables
from .test_torch_cascade_rcnn import linear_heads
from .test_torch_fcos_family import (NUM_CLASSES, assert_get_bboxes_match,
                                     assert_maps_close, detector_pair,
                                     leaf_shapes, shipped)
from .test_torch_reppoints import drawn_step
from . import torch_fixtures  # noqa: F401  (one intra-op thread)

KEYS = ('loss_loc', 'loss_shape', 'loss_cls', 'loss_bbox')
RPN_KEYS = ('loss_rpn_loc', 'loss_rpn_shape', 'loss_rpn_cls',
            'loss_rpn_bbox')
SIZES = [(16, 16), (8, 8), (4, 4), (2, 2), (1, 1)]


def retina_cfg(levels=3):
    """The test config at 5 classes, its top ``levels`` of P3-P5."""
    c = shipped(ga_retina_cfg())
    c['bbox_head'] = dict(c['bbox_head'], num_classes=NUM_CLASSES,
                          strides=(8, 16, 32)[-levels:])
    c['backbone'] = dict(c['backbone'], out_indices=[1, 2, 3][-levels:])
    c['neck'] = dict(c['neck'], in_channels=[128, 256, 512][-levels:],
                     num_outs=levels, add_extra_convs=False)
    return c


def faster_cfg(levels=3):
    """tpudet's GA Faster R-CNN test config at 5 classes, 16 sampled rois
    an image and 300 proposals, the GA-RPN on P2 to P(1 + levels)."""
    strides = (4, 8, 16)[:levels]
    return dict(
        type='FasterRCNN',
        backbone=dict(type='ResNet', depth=18,
                      out_indices=[0, 1, 2][:levels]),
        neck=dict(type='FPN', in_channels=[64, 128, 256][:levels],
                  out_channels=32, num_outs=levels),
        rpn_head=dict(type='GARPNHead', in_channels=32, feat_channels=32,
                      strides=strides),
        roi_head=dict(type='StandardRoIHead', num_classes=NUM_CLASSES,
                      in_channels=32, num_samples=16,
                      featmap_strides=strides),
        train_cfg=dict(rpn_proposal=dict(nms_pre=200, max_per_img=300,
                                         nms=dict(iou_threshold=0.7))),
        test_cfg=dict(rpn=dict(nms_pre=200, max_per_img=300,
                               nms=dict(iou_threshold=0.7)),
                      rcnn=dict(score_thr=0.05, nms=dict(iou_threshold=0.5),
                                max_per_img=20)))


# the losses and targets

@pytest.mark.parametrize('weighted', [False, True])
def test_bounded_iou_loss_and_gradient_match_tpudet(weighted):
    rng = np.random.RandomState(80 + weighted)
    xy = rng.uniform(0, 50, (2, 40, 2))
    pred = np.concatenate([xy, xy + rng.uniform(1, 30, (2, 40, 2))], -1)
    xy = xy + rng.uniform(-10, 10, (2, 40, 2))
    target = np.concatenate([xy, xy + rng.uniform(1, 30, (2, 40, 2))], -1)
    target[:, :3] = pred[:, :3]  # equal: every term ~0 (eps), the centre
    # terms' gradient jnp.abs's at 0
    pred, target = pred.astype(np.float32), target.astype(np.float32)
    weight = rng.uniform(0, 1, (2, 40, 4)).astype(np.float32)
    kw = dict(beta=0.2)
    jkw = dict(kw, weight=jnp.asarray(weight), reduction='sum') \
        if weighted else dict(kw, reduction='none')
    tkw = dict(kw, weight=torch.from_numpy(weight), reduction='sum') \
        if weighted else dict(kw, reduction='none')
    _, ref_grad = jax.value_and_grad(
        lambda p, t: jnp.sum(jlosses.bounded_iou_loss(p, t, **jkw)),
        argnums=(0, 1))(jnp.asarray(pred), jnp.asarray(target))
    ref_vals = jlosses.bounded_iou_loss(jnp.asarray(pred),
                                        jnp.asarray(target), **jkw)
    tp = torch.from_numpy(pred).requires_grad_()
    tt = torch.from_numpy(target).requires_grad_()
    got = tlosses.bounded_iou_loss(tp, tt, **tkw)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref_vals),
                               rtol=1e-5, atol=1e-7)
    assert float(np.abs(np.asarray(ref_grad[1])).max()) == 0
    assert tt.grad is None or float(tt.grad.abs().max()) == 0
    r = np.asarray(ref_grad[0])
    np.testing.assert_allclose(tp.grad.numpy(), r, rtol=1e-5,
                               atol=1e-5 * np.abs(r).max())
    if not weighted:
        assert (got.detach().numpy()[:, :3] < 1e-6).all()


def loc_cases():
    """Random gts in image 0; in image 1 overlapping rings (a later gt's
    ignore ring over an earlier gt's centre) and gts on adjacent levels."""
    boxes, _, valid = gts(82)
    boxes[1, :4] = [[20., 20., 60., 60.], [30., 30., 74., 70.],
                    [8., 70., 40., 120.], [0., 0., 128., 128.]]
    valid[1, :4] = True
    return boxes, valid


def test_loc_targets_equal_tpudets():
    jhead = jax_build_head(dict(type='GARetinaHead', num_classes=4,
                                in_channels=16))
    head = GARetinaHead(num_classes=4, in_channels=16, feat_channels=16)
    boxes, valid = loc_cases()
    ref, ref_avg = jhead.loc_targets(SIZES, jnp.asarray(boxes),
                                     jnp.asarray(valid))
    got, avg = head.loc_targets(SIZES, torch.from_numpy(boxes),
                                torch.from_numpy(valid))
    assert avg.dtype == torch.float32 and float(avg) == np.float32(ref_avg)
    kinds = set()
    for (t, w), (rt, rw) in zip(got, ref):
        np.testing.assert_array_equal(t.numpy(), np.asarray(rt))
        np.testing.assert_array_equal(w.numpy(), np.asarray(rw))
        kinds |= set(np.unique(w.numpy()).tolist())
    assert kinds == {0.0, np.float32(0.1), 1.0}
    # image 1, P3: gt 1's ignore ring zeroes some of gt 0's centre cells
    t, w = (m[1].numpy() for m in got[0])
    assert ((t == 1) & (w == 0)).any() and ((t == 1) & (w == 1)).any()


# GA RetinaNet

@pytest.fixture(scope='module')
def pair():
    return detector_pair(retina_cfg(), 83)


def test_pred_maps_match_tpudet(pair):
    _, _, det, _, ref, got = pair
    assert type(det.model) is GARetinaNet
    assert [m[0].shape[-1] for m in got] == [NUM_CLASSES, 4, 2, 1]
    # the shapes spread: guided anchors far from the squares
    assert float(got[2][0].float().std()) > 0.3
    assert_maps_close(got, ref)


def x64_loss(loss, model_loss, ref, keys, *gt):
    """``loss`` (tpudet's, jitted) and ``model_loss`` (the port's) on
    tpudet's maps in float64, with their gradients with respect to the
    maps: each term rtol 1e-6, the gradients rtol 1e-6, atol 1e-9 of the
    largest |value|. Returns the port's losses."""
    maps = jax.tree.map(lambda a: np.asarray(a, np.float64), ref)
    with jax.enable_x64(True):
        def total(preds):
            out = loss(preds, *map(jnp.asarray, gt))
            return sum(out[k] for k in keys), out
        (_, jl), jg = jax.jit(jax.value_and_grad(total, has_aux=True))(
            jax.tree.map(jnp.asarray, maps))
        jl, jg = jax.device_get((jl, jg))
    tmaps = jax.tree.map(lambda a: torch.tensor(a).requires_grad_(), maps)
    tl = model_loss(tmaps, *map(torch.from_numpy, gt))
    sum(tl[k] for k in keys).backward()
    assert set(tl) == set(jl)
    for k in tl:
        np.testing.assert_allclose(float(tl[k].detach()), float(jl[k]),
                                   rtol=1e-6, err_msg=k)
    for t, r in zip(jax.tree.leaves(tmaps), jax.tree.leaves(jg)):
        g = np.zeros(r.shape) if t.grad is None else t.grad.numpy()
        np.testing.assert_allclose(g, r, rtol=1e-6,
                                   atol=1e-9 * max(np.abs(r).max(), 1))
    return {k: float(v.detach()) for k, v in tl.items()}


@pytest.mark.parametrize('case', ['gts', 'ties', 'none'])
def test_loss_and_gradients_match_tpudet_in_float64(pair, case):
    jmodel, _, det, _, ref, _ = pair
    boxes, labels, valid = gts(84)
    if case == 'ties':  # two copies of one box, off whole pixels
        boxes[1, :2] = [[20.37, 28.37, 90.37, 76.37]] * 2
        valid[1, :2] = True
    valid[:] = valid & (case != 'none')
    tl = x64_loss(jmodel.loss, det.model.loss, ref, KEYS, boxes, labels,
                  valid)
    if case != 'none':
        assert all(tl[k] > 0 for k in KEYS)


@pytest.mark.parametrize('rescale', [False, True])
def test_get_bboxes_matches_tpudet(pair, rescale):
    jmodel, _, det, _, ref, got = pair
    assert_get_bboxes_match(jmodel, det.model, ref, got, rescale, None)


# the GA-RPN

@pytest.fixture(scope='module')
def rpn_pair():
    """(tpudet's detector, the port's, tpudet's GA-RPN maps of random
    images) on random weights."""
    cfg = faster_cfg()
    jmodel = jax_build_detector(cfg)
    variables = jax.tree.map(np.asarray, random_variables(leaf_shapes(cfg),
                                                          85))
    # location logits around log(0.01 / 0.99): the filter drops about half
    variables['params']['rpn_head']['conv_loc']['bias'] = np.full(
        1, -4.6, np.float32)
    model = build_detector(cfg)
    load_flax_variables(model, variables)
    ref = jax.jit(lambda v, x: jmodel.apply(
        v, x, method=lambda m, x: m.rpn_head(m.extract_feat(x))))(
            variables, jnp.asarray(images(85)))
    return jmodel, model, ref


def test_rpn_loss_and_gradients_match_tpudet_in_float64(rpn_pair):
    jmodel, model, ref = rpn_pair
    assert isinstance(model.rpn_head, GARPNHead)
    boxes, labels, valid = gts(86)
    tl = x64_loss(jmodel.rpn_head.loss, model.rpn_head.loss, ref, RPN_KEYS,
                  boxes, labels, valid)
    assert all(tl[k] > 0 for k in RPN_KEYS)


def test_get_proposals_matches_tpudet(rpn_pair):
    jmodel, model, ref = rpn_pair
    kw = dict(img_shape=(128, 128), nms_pre=200, max_num=300, iou_thr=0.7)
    rj = jax.jit(lambda maps: jmodel.rpn_head.get_proposals(maps, **kw))(ref)
    rt = model.rpn_head.get_proposals(jax.tree.map(
        lambda a: torch.tensor(np.asarray(a)), ref), **kw)
    np.testing.assert_array_equal(rt[2].numpy(), np.asarray(rj[2]))
    np.testing.assert_allclose(rt[1].numpy(), np.asarray(rj[1]), atol=1e-6)
    np.testing.assert_allclose(rt[0].numpy(), np.asarray(rj[0]), atol=1e-3)
    assert 50 < int(rt[2].sum(1).min()) <= 300
    loc = np.concatenate([np.asarray(m).reshape(-1) for m in ref[3]])
    kept = 1 / (1 + np.exp(-loc)) >= 0.01  # the filter drops cells
    assert 0.1 < kept.mean() < 0.9


def test_the_config_caps_the_proposals_at_300():
    from tpudet_torch.config import Config
    cfg = Config.fromfile(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        'configs/guided_anchoring/ga_faster_r50_fpn_1x_coco.py'))
    with torch.device('meta'):
        model = build_detector(cfg['model'])
    assert isinstance(model.rpn_head, GARPNHead)
    assert model.test_cfg['rpn']['max_per_img'] == 300
    assert model.train_cfg['rpn_proposal']['max_per_img'] == 300


# the float64 steps

def test_a_retinanet_train_step_matches_tpudet_in_float64():
    cfg = retina_cfg(1)
    cfg['bbox_head'] = dict(cfg['bbox_head'], stacked_convs=1)
    assert_step_matches(*drawn_step(cfg, 87)[:5], KEYS)


def test_a_faster_rcnn_train_step_matches_tpudet_in_float64():
    results = drawn_step(faster_cfg(1), 88, forward_train=True,
                         adjust=linear_heads)
    assert_step_matches(*results[:5], RPN_KEYS + ('loss_cls', 'loss_bbox'))
