"""The Cascade RPN (``anchor_offsets``, ``StageCascadeRPN``,
``CascadeRPNHead``) in tpudet_torch against tpudet, on the CPU.

- ``anchor_offsets`` of random anchors in float64 and fp32: equal to
  tpudet's (rtol 1e-12 / bit for bit), the cell's own square anchor at 0;
- the region assignment of stage 0 on random gts and on ties: a cell
  that two gts' centre regions cover goes to the higher gt index, a gt on
  another level claims nothing here, a region side at a half cell rounds
  to even; held through ``loss``;
- the head in tpudet's test detector (ResNet-18, a 64-channel FPN) at
  128 px on random weights (stage 0's regression spread so that the
  refined anchors and the deformable taps move off the grid): the three
  maps within 1e-4 of each map's largest |value|; ``loss`` on tpudet's
  maps (both cast them to fp32) rtol 1e-6 and its gradients with respect
  to the maps rtol 1e-5 (atol 1e-5 of the largest), with gts, tie gts
  and none; ``get_proposals`` of tpudet's maps at 300 an
  image, IoU 0.8: equal (boxes 1e-3 px, scores 1e-6);
- the shipped config carries 1000 / 2000 pre-NMS, 300 proposals and IoU
  0.8 through ``proposal_kwargs`` to both paths;
- the sample's ties: the 256 anchors come from numpy ``RandomState(7)``'s
  priority by a double stable sort (every other anchor at 2.0);
- one float64 train step of the Cascade RPN Faster R-CNN from the same
  random weights on one level (P2 alone, 32 channels: XLA compiles
  tpudet's float64 deformable backward for seconds a site), 2 images of
  64 px: the losses and the gradient norm rtol 1e-4, the state within
  5e-3 of the step's change.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet.models.builder import build_detector as jax_build_detector
from tpudet.models.dense_heads.cascade_rpn_head import \
    anchor_offsets as janchor_offsets
from tpudet_torch.core.assigners import priority_rank
from tpudet_torch.models.builder import build_detector
from tpudet_torch.models.dense_heads.cascade_rpn_head import (
    CascadeRPNHead, anchor_offsets)
from tpudet_torch.models.dense_heads.rpn_head import fixed_priority
from tpudet_torch.models.detectors.two_stage import proposal_kwargs
from tpudet_torch.utils.flax_import import load_flax_variables

from .test_torch_atss_gfl import assert_step_matches, gts, images
from .test_torch_backbone_neck import random_variables
from .test_torch_cascade_rcnn import linear_heads
from .test_torch_fcos_family import leaf_shapes
from .test_torch_reppoints import drawn_step
from . import torch_fixtures  # noqa: F401  (one intra-op thread)

KEYS = ('loss_rpn_reg_s0', 'loss_rpn_cls', 'loss_rpn_bbox')


def cfg(levels=5, channels=64):
    """tpudet's Cascade RPN test detector (``tests/test_models/
    test_cascade_rpn.py``) at 300 proposals, on the first ``levels`` of
    strides 4-64."""
    strides = (4, 8, 16, 32, 64)[:levels]
    return dict(
        type='FasterRCNN',
        backbone=dict(type='ResNet', depth=18,
                      out_indices=[0, 1, 2, 3][:min(levels, 4)]),
        neck=dict(type='FPN', in_channels=[64, 128, 256, 512][:min(
            levels, 4)], out_channels=channels, num_outs=levels),
        rpn_head=dict(type='CascadeRPNHead', in_channels=channels,
                      feat_channels=channels, strides=strides),
        roi_head=dict(type='StandardRoIHead', num_classes=4,
                      in_channels=channels, num_samples=16,
                      featmap_strides=strides[:4]),
        train_cfg=dict(rpn_proposal=dict(nms_pre=200, max_per_img=300,
                                         nms=dict(iou_threshold=0.8))),
        test_cfg=dict(rpn=dict(nms_pre=200, max_per_img=300,
                               nms=dict(iou_threshold=0.8)),
                      rcnn=dict(score_thr=0.05, nms=dict(iou_threshold=0.5),
                                max_per_img=20)))


# the offsets and the region assignment

@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_anchor_offsets_equal_tpudets(dtype):
    rng = np.random.RandomState(50)
    h, w, stride = 5, 7, 8
    cx = (np.tile(np.arange(w), h) * stride)[None, :, None]
    cy = (np.repeat(np.arange(h), w) * stride)[None, :, None]
    half = rng.uniform(4, 40, (2, h * w, 2))
    shift = rng.uniform(-10, 10, (2, h * w, 2))
    anchors = np.concatenate([cx + shift[..., :1] - half[..., :1],
                              cy + shift[..., 1:] - half[..., 1:],
                              cx + shift[..., :1] + half[..., :1],
                              cy + shift[..., 1:] + half[..., 1:]],
                             -1).astype(dtype)
    anchors[0, 0] = [-8., -8., 8., 8.]  # the cell's own 2-stride square
    with jax.enable_x64(dtype == np.float64):
        ref = np.asarray(janchor_offsets(jnp.asarray(anchors), stride,
                                         (h, w)))
    got = anchor_offsets(torch.from_numpy(anchors), stride, (h, w)).numpy()
    assert got.shape == (2, h, w, 18)
    if dtype == np.float32:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)
    assert not got[0, 0, 0].any()


def test_region_claims_take_the_higher_gt_on_overlaps():
    """Two 30-px gts of stride 4's level whose centre regions share a cell:
    it goes to gt 1; the 120-px gt 2 belongs to stride 8's level and
    claims nothing at stride 4. gt 0's region spans cells round(4.5) to
    round(6.0), that is 4 to 6 (half to even), gt 1's 6 to 8."""
    head = CascadeRPNHead(in_channels=8, feat_channels=8, strides=(4, 8))
    boxes = np.array([[[6., 6., 36., 36.], [14., 14., 44., 44.],
                       [0., 0., 120., 120.]]])
    valid = np.ones((1, 3), bool)
    claims = head.region_claims([(32, 32), (16, 16)],
                                torch.from_numpy(boxes),
                                torch.from_numpy(valid)).numpy()[0]
    lvl0 = claims[:32 * 32].reshape(32, 32)
    lvl1 = claims[32 * 32:].reshape(16, 16)
    assert set(np.unique(lvl0)) == {-1, 0, 1}
    assert set(np.unique(lvl1)) == {-1, 2}
    assert (lvl0[3, 3], lvl0[4, 4], lvl0[5, 5], lvl0[6, 6], lvl0[8, 8],
            lvl0[9, 9]) == (-1, 0, 0, 1, 1, -1)
    assert (lvl0 == 0).sum() == 9 - 1 and (lvl0 == 1).sum() == 9


def test_the_sample_takes_the_lowest_priorities_by_index():
    """The stage-1 sample's ranks: a double stable sort of the priority,
    every non-candidate at 2.0; equal priorities rank by index."""
    prio = fixed_priority(10, 7, 'cpu')
    prio[3] = prio[1]  # a tie
    mask = torch.tensor([[True, True, False, True, True, False, True,
                          False, True, True]])
    rank = priority_rank(mask, prio)[0]
    keyed = torch.where(mask[0], prio, torch.full_like(prio, 2.0)).numpy()
    ref = np.argsort(np.argsort(keyed, kind='stable'), kind='stable')
    np.testing.assert_array_equal(rank.numpy(), ref)
    assert rank[1] < rank[3]


# the head in the detector

@pytest.fixture(scope='module')
def pair():
    """(tpudet's detector, the port's, tpudet's Cascade RPN maps of random
    images, the port's) on random weights, stage 0's regression spread."""
    c = cfg()
    jmodel = jax_build_detector(c)
    variables = jax.tree.map(np.asarray, random_variables(leaf_shapes(c),
                                                          51))
    reg = variables['params']['rpn_head']['stage0']['rpn_reg']
    reg['kernel'] = reg['kernel'] * 3.0
    model = build_detector(c)
    load_flax_variables(model, variables)
    model.eval()
    img = images(51)
    ref = jax.jit(lambda v, x: jmodel.apply(
        v, x, method=lambda m, x: m.rpn_head(m.extract_feat(x))))(
            variables, jnp.asarray(img))
    with torch.no_grad():
        got = model.rpn_head(model.extract_feat(torch.from_numpy(img)))
    return jmodel, model, ref, got


def test_maps_match_tpudet(pair):
    *_, ref, got = pair
    for g_lvls, r_lvls in zip(got, ref):
        assert len(g_lvls) == 5
        for g, r in zip(g_lvls, r_lvls):
            r = np.asarray(r)
            assert tuple(g.shape) == r.shape
            np.testing.assert_allclose(g.numpy(), r,
                                       atol=1e-4 * np.abs(r).max())
    # the refined anchors moved the taps: offsets well off the grid
    d = np.abs(np.asarray(ref[0][0])).max()
    assert d > 0.5


def loss_and_gradients(loss, model_loss, ref, keys, *gt):
    """``loss`` (tpudet's, jitted) and ``model_loss`` (the port's) on
    tpudet's maps given in float64, with their gradients with respect to
    the maps. Both cast the maps to fp32 (``cascade_rpn_head.py:178-182``),
    so the terms hold to rtol 1e-6 and the gradients to rtol 1e-5, atol
    1e-5 of the largest |value|. Returns the port's losses."""
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
        np.testing.assert_allclose(g, r, rtol=1e-5,
                                   atol=1e-5 * max(np.abs(r).max(), 1e-12))
    return {k: float(v.detach()) for k, v in tl.items()}


@pytest.mark.parametrize('case', ['gts', 'ties', 'none'])
def test_loss_and_gradients_match_tpudet(pair, case):
    jmodel, model, ref, _ = pair
    boxes, labels, valid = gts(52, num_classes=4)
    if case == 'ties':  # two copies of one box, off whole pixels
        boxes[1, :2] = [[20.37, 28.37, 90.37, 76.37]] * 2
        valid[1, :2] = True
    valid[:] = valid & (case != 'none')
    tl = loss_and_gradients(jmodel.rpn_head.loss, model.rpn_head.loss, ref,
                            KEYS, boxes, labels, valid)
    if case != 'none':
        assert all(tl[k] > 0 for k in KEYS)


def test_get_proposals_matches_tpudet(pair):
    jmodel, model, ref, _ = pair
    kw = dict(img_shape=(128, 128), nms_pre=200, max_num=300, iou_thr=0.8)
    rj = jax.jit(lambda maps: jmodel.rpn_head.get_proposals(maps, **kw))(ref)
    rt = model.rpn_head.get_proposals(jax.tree.map(
        lambda a: torch.tensor(np.asarray(a)), ref), **kw)
    np.testing.assert_array_equal(rt[2].numpy(), np.asarray(rj[2]))
    np.testing.assert_allclose(rt[1].numpy(), np.asarray(rj[1]), atol=1e-6)
    np.testing.assert_allclose(rt[0].numpy(), np.asarray(rj[0]), atol=1e-3)
    assert 100 < int(rt[2].sum(1).min()) <= 300


def test_the_config_carries_its_proposal_caps():
    from tpudet_torch.config import Config
    c = Config.fromfile(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        'configs/cascade_rpn/crpn_faster_rcnn_r50_caffe_fpn_1x_coco.py'))
    with torch.device('meta'):
        model = build_detector(c['model'])
    assert isinstance(model.rpn_head, CascadeRPNHead)
    assert proposal_kwargs(model.test_cfg['rpn'], 1000) == dict(
        nms_pre=1000, max_num=300, iou_thr=0.8)
    assert proposal_kwargs(model.train_cfg['rpn_proposal'], 2000) == dict(
        nms_pre=2000, max_num=300, iou_thr=0.8)


# the float64 step

def test_a_faster_rcnn_train_step_matches_tpudet_in_float64():
    c = cfg(levels=1, channels=32)
    results = drawn_step(c, 53, forward_train=True, adjust=spread_stage0)
    assert_step_matches(*results[:5], KEYS + ('loss_cls', 'loss_bbox'))


def spread_stage0(params):
    """Stage 0's regression spread (as the pair's), the RoI head's ReLU
    inputs above 0 (``linear_heads``)."""
    params = linear_heads(params)
    reg = params['rpn_head']['stage0']['rpn_reg']
    reg['kernel'] = reg['kernel'] * 3.0
    return params
