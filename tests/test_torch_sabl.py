"""SABL (``BucketingBBoxCoder``, ``SABLRetinaHead``, ``SABLBBoxHead``,
``SABLRoIHead``) in tpudet_torch against tpudet, on the CPU.

- ``BucketingBBoxCoder``: encode and decode (clipped or not) of random
  boxes in float64 equal to tpudet's (rtol 1e-12 where continuous, the
  labels, ranks and weights exactly); the round trip (a gt's own targets
  decode to it within 1e-9 px); the ties: a side midway between two bucket
  centres takes the lower bucket (``jnp.argsort``'s stable order), and of
  equal top logits the lower bucket comes first, which decides the
  adjacency of the rescoring;
- ``SABLBBoxHead`` alone on random (N, 7, 7, C) features (no symmetry: a
  1-D transposed conv's kernel taken unflipped, or the side-aware split's
  reversal left out, shows) and its input gradient: within 1e-5 of each
  output's largest |value|, fp32;
- SABL RetinaNet: tpudet's test config (ResNet-18, a 32-channel FPN, one
  stacked conv) with 5 classes and the shipped caps, 128 px, random
  weights (``test_torch_fcos_family.py``'s helpers and tolerances: maps
  1e-4; the loss terms and their gradients on tpudet's maps rtol 1e-5;
  the keeps of ``get_bboxes`` equal, end to end one-to-one); the
  approx-max-IoU assignment's ties (a nested gt with the same IoU at a
  cell: the lower gt index; two gts claiming one cell at low quality: the
  higher) in the loss;
- ``SABLRoIHead`` on ResNet-like random features and 800 rois an image:
  pooling and head within 1e-5; ``loss`` in float64 on tpudet's head
  outputs and the port's sampled rois (the bucket choices are taken on
  decoded gts), rtol 1e-6 and its gradients; ``get_bboxes`` of tpudet's
  outputs, the keeps equal;
- one float64 train step of SABL RetinaNet and of SABL Faster R-CNN
  (every RoI head ReLU input moved above 0: RoIAlign's fp32 sample points
  round apart in the two packages) from the same random weights, 2 images
  of 64 px: the losses and gradient norm rtol 1e-4, the state within
  5e-3 of the step's change.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet.core.bbox import BucketingBBoxCoder as JCoder
from tpudet.models.roi_heads.sabl_roi_head import SABLBBoxHead as JBBoxHead
from tpudet.models.roi_heads.sabl_roi_head import SABLRoIHead as JRoIHead
from tpudet_torch.core.bbox import BucketingBBoxCoder
from tpudet_torch.models.detectors.single_stage import SABLRetinaNet
from tpudet_torch.models.roi_heads.sabl_roi_head import (SABLBBoxHead,
                                                         SABLRoIHead)
from tpudet_torch.utils.flax_import import load_flax_variables

from .test_models.test_sabl import sabl_cfg
from .test_torch_atss_gfl import assert_step_matches, gts
from .test_torch_backbone_neck import random_variables
from .test_torch_fcos_family import (NUM_CLASSES, assert_get_bboxes_match,
                                     assert_loss_and_map_gradients,
                                     assert_maps_close, detector_pair,
                                     shipped)
from .test_torch_reppoints import drawn_step
from .test_torch_roi_head import _feats, _proposals, _t
from .test_torch_roi_head import assert_detections_equal
from . import torch_fixtures  # noqa: F401  (one intra-op thread)

KEYS = ('loss_cls', 'loss_bbox_cls', 'loss_bbox_reg')
ROI_KEYS = ('loss_cls', 'loss_bucket_cls', 'loss_bucket_reg')


def random_boxes(rng, n, lo=1., hi=60.):
    xy = rng.uniform(0, 100, (n, 2))
    return np.concatenate([xy, xy + rng.uniform(lo, hi, (n, 2))], -1)


# the coder

@pytest.mark.parametrize('scale', [3.0, 1.7])
def test_bucketing_coder_matches_tpudet(scale):
    rng = np.random.RandomState(int(scale * 10))
    props = random_boxes(rng, 200)
    gts_ = props + rng.uniform(-0.3, 0.3, (200, 4)) * (
        props[:, 2:] - props[:, :2])[:, [0, 1, 0, 1]]
    jc, tc = JCoder(14, scale), BucketingBBoxCoder(14, scale)
    with jax.enable_x64(True):
        ref = jax.device_get(jc.encode(jnp.asarray(props), jnp.asarray(gts_)))
        preds = (rng.randn(200, 28) * 2, rng.randn(200, 28) * 0.3)
        for shape in (None, (90., 120.)):
            jdec = jax.device_get(jc.decode(
                jnp.asarray(props), tuple(map(jnp.asarray, preds)),
                max_shape=shape))
            tdec = tc.decode(torch.from_numpy(props),
                             tuple(map(torch.from_numpy, preds)),
                             max_shape=shape)
            for g, r in zip(tdec, jdec):
                np.testing.assert_allclose(g.numpy(), r, rtol=1e-12,
                                           atol=1e-9)
    got = tc.encode(torch.from_numpy(props), torch.from_numpy(gts_))
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.shape == r.shape == (200, 4, 7)
        if i == 2:
            np.testing.assert_allclose(g.numpy(), r, rtol=1e-12)
        else:
            np.testing.assert_array_equal(g.numpy(), r)


def test_bucketing_coder_round_trip():
    """A gt's own targets (its bucket one-hot as logits, its offsets)
    decode back to it, where every side lies inside the rescaled proposal."""
    rng = np.random.RandomState(5)
    props = random_boxes(rng, 100, 20., 60.)
    gts_ = props + rng.uniform(-0.2, 0.2, (100, 4)) * (
        props[:, 2:] - props[:, :2])[:, [0, 1, 0, 1]]
    tc = BucketingBBoxCoder(14, 3.0)
    labels, _, offsets, _ = tc.encode(torch.from_numpy(props),
                                      torch.from_numpy(gts_))
    boxes, conf = tc.decode(torch.from_numpy(props),
                            ((labels * 50).reshape(100, 28),
                             offsets.reshape(100, 28)))
    np.testing.assert_allclose(boxes.numpy(), gts_, atol=1e-9)
    np.testing.assert_allclose(conf.numpy(), 1.0, rtol=1e-12)


def test_bucketing_ties_take_the_lower_bucket():
    """Proposal [0, 0, 14, 14] at scale 1: bucket centres 0.5, 1.5, ... A
    left side at 1.0 (or a right side at 13.0) lies midway between
    buckets 0 and 1: the nearest is bucket 0, as tpudet's. Top logits
    equal at buckets 2 and 5 pick bucket 2; equal at 0, 1 and 2 pick (0,
    1), adjacent, so the runner-up adds to the confidence."""
    jc, tc = JCoder(14, 1.0), BucketingBBoxCoder(14, 1.0)
    props = np.array([[0., 0., 14., 14.]] * 2)
    gts_ = np.array([[1., 3.25, 13., 10.], [2., 1., 12.5, 13.]])
    ref = jc.encode(jnp.asarray(props, jnp.float32),
                    jnp.asarray(gts_, jnp.float32))
    got = tc.encode(torch.tensor(props, dtype=torch.float32),
                    torch.tensor(gts_, dtype=torch.float32))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert got[0][0, 0, 0] == 1 and got[0][0, 1, 0] == 1  # l and r: bucket 0
    assert got[0][1, 1, 1] == 1  # r at 12.5 exactly on bucket 1's centre
    logits = np.zeros((2, 4, 7), np.float32)
    logits[0, :, [2, 5]] = 5.
    logits[1, :, :3] = 5.
    offs = np.zeros((2, 28), np.float32)
    jb, jconf = jc.decode(jnp.asarray(props, jnp.float32),
                          (jnp.asarray(logits.reshape(2, 28)),
                           jnp.asarray(offs)))
    tb, tconf = tc.decode(torch.tensor(props, dtype=torch.float32),
                          (torch.from_numpy(logits.reshape(2, 28)),
                           torch.from_numpy(offs)))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tconf.numpy(), np.asarray(jconf))
    # bucket 2's centre; the runner-up (5) not adjacent: about 1/2; the
    # runner-up of the three (bucket 1) adjacent: about 2/3, not 1/3
    assert tb[0, 0] == 2.5 and tconf[0] < 0.5 < tconf[1]


# the RoI bbox head alone

def test_sabl_bbox_head_and_its_input_gradient_match_tpudet():
    x = np.random.RandomState(6).randn(12, 7, 7, 8).astype(np.float32)
    jhead = JBBoxHead(num_classes=3, in_channels=8, fc_out_channels=32,
                      reg_feat_channels=16)
    variables = random_variables(jax.eval_shape(
        jhead.init, jax.random.PRNGKey(0), jnp.asarray(x)), 7)
    head = SABLBBoxHead(3, 8, fc_out_channels=32, reg_feat_channels=16)
    load_flax_variables(head, variables)
    up = variables['params']['x_up']['kernel']
    assert up.shape == (2, 16, 16) and not np.allclose(up[0], up[1])
    w = [np.random.RandomState(8 + i).randn(*s).astype(np.float32)
         for i, s in enumerate(((12, 4), (12, 28), (12, 28)))]

    def jtotal(inp):
        outs = jhead.apply(variables, inp)
        return sum(jnp.sum(o * wi) for o, wi in zip(outs, w)), outs
    (_, ref), jg = jax.jit(jax.value_and_grad(jtotal, has_aux=True))(
        jnp.asarray(x))
    tx = _t(x).requires_grad_()
    got = head(tx)
    sum((o * _t(wi)).sum() for o, wi in zip(got, w)).backward()
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert tuple(g.shape) == r.shape
        np.testing.assert_allclose(g.detach().numpy(), r,
                                   atol=1e-5 * np.abs(r).max())
    r = np.asarray(jg)
    np.testing.assert_allclose(tx.grad.numpy(), r, atol=1e-5 * np.abs(r).max())


# SABL RetinaNet

def retina_cfg():
    return shipped(sabl_cfg(NUM_CLASSES))


@pytest.fixture(scope='module')
def pair():
    return detector_pair(retina_cfg(), 70)


def test_pred_maps_match_tpudet(pair):
    _, _, det, _, ref, got = pair
    assert type(det.model) is SABLRetinaNet
    assert [g.shape[-1] for g in (got[0][0], got[1][0], got[2][0])] == [
        NUM_CLASSES, 28, 28]
    assert_maps_close(got, ref)


@pytest.mark.parametrize('empty', [False, True])
def test_loss_and_gradients_match_tpudet(pair, empty):
    jmodel, _, det, _, ref, _ = pair
    boxes, labels, valid = gts(71)
    valid[:] = valid & (not empty)
    tl = assert_loss_and_map_gradients(jmodel, det.model, ref, boxes, labels,
                                       valid, KEYS)
    if not empty:
        assert all(float(tl[k]) > 0 for k in KEYS)


def test_approx_assignment_ties_in_the_loss(pair):
    """Gts that tie: two copies of one box (every cell's IoU equal: the
    lower index takes the positives, and the higher claims each gt's best
    cells at low quality), and a small box whose best IoU is under 0.4
    (claimed at low quality only)."""
    jmodel, _, det, _, ref, _ = pair
    boxes = np.zeros((2, 4, 4), np.float32)
    boxes[0, :3] = [[16., 16., 80., 80.], [16., 16., 80., 80.],
                    [90., 90., 96., 93.]]
    boxes[1, :2] = [[40., 8., 120., 56.], [40., 8., 120., 56.]]
    # off the integers: a side on a whole pixel puts bucket offsets at
    # exactly 1.0, where tpudet's jitted arithmetic (a reciprocal
    # multiply) and its eager one round to either side of the neighbour
    # rule's bound
    boxes[:, :3] += np.float32(0.37)
    valid = np.zeros((2, 4), bool)
    valid[0, :3] = valid[1, :2] = True
    labels = np.array([[1, 2, 3, 0], [4, 0, 0, 0]], np.int32)
    tl = assert_loss_and_map_gradients(jmodel, det.model, ref, boxes, labels,
                                       valid, KEYS)
    assert all(float(tl[k]) > 0 for k in KEYS)


@pytest.mark.parametrize('rescale', [False, True])
def test_get_bboxes_matches_tpudet(pair, rescale):
    jmodel, _, det, _, ref, got = pair
    assert_get_bboxes_match(jmodel, det.model, ref, got, rescale, None)


# the SABL RoI head

@pytest.fixture(scope='module')
def roi_pair():
    jhead = JRoIHead(num_classes=3, in_channels=16)
    feats = _feats(0)
    props, valid = _proposals(1)
    args = (tuple(jnp.asarray(f) for f in feats), jnp.asarray(props),
            jnp.asarray(valid))
    variables = random_variables(jax.eval_shape(
        jhead.init, jax.random.PRNGKey(0), *args), 72)
    head = SABLRoIHead(num_classes=3, in_channels=16)
    load_flax_variables(head, variables)
    ref = jax.jit(jhead.apply)(variables, *args)
    with torch.no_grad():
        got = head([_t(f).permute(0, 3, 1, 2) for f in feats], _t(props),
                   _t(valid))
    return jhead, head, props, valid, ref, got


def test_roi_pooling_and_head_match_tpudet(roi_pair):
    *_, ref, got = roi_pair
    for g, r in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
        r = np.asarray(r)
        assert tuple(g.shape) == r.shape
        np.testing.assert_allclose(g.numpy(), r, atol=1e-5 * np.abs(r).max())


def test_roi_loss_and_gradients_match_tpudet_in_float64(roi_pair):
    jhead, head, props, valid, ref, _ = roi_pair
    boxes, labels, gvalid = gts(73, num_classes=3)
    rois, sampled, lab, targets, pos = head.sample_rois(
        _t(props), _t(valid), _t(boxes), _t(labels), _t(gvalid),
        num_samples=64)
    # tpudet's head outputs at the first 64 rois stand in for the sampled
    # ones' (the loss reads them only)
    outs = jax.tree.map(lambda a: np.asarray(a, np.float64)[:, :64], ref)
    args = [np.asarray(a) for a in (lab, targets, pos, sampled)]
    rois = rois.double().numpy()
    args[1] = args[1].astype(np.float64)
    with jax.enable_x64(True):
        def total(o):
            out = jhead.loss(o[0], o[1], *map(jnp.asarray, args),
                             rois=jnp.asarray(rois))
            return sum(out.values()), out
        (_, jl), jg = jax.jit(jax.value_and_grad(total, has_aux=True))(
            jax.tree.map(jnp.asarray, outs))
        jl, jg = jax.device_get((jl, jg))
    touts = jax.tree.map(lambda a: torch.tensor(a).requires_grad_(), outs)
    tl = head.loss(touts[0], touts[1], *map(torch.from_numpy, args),
                   rois=torch.from_numpy(rois))
    sum(tl.values()).backward()
    assert set(tl) == set(jl) == set(ROI_KEYS) and int(pos.sum()) > 4
    for k in tl:
        np.testing.assert_allclose(float(tl[k].detach()), float(jl[k]),
                                   rtol=1e-6, err_msg=k)
    for t, r in zip(jax.tree.leaves(touts), jax.tree.leaves(jg)):
        np.testing.assert_allclose(t.grad.numpy(), r, rtol=1e-6,
                                   atol=1e-9 * np.abs(r).max())


def test_roi_get_bboxes_matches_tpudet(roi_pair):
    jhead, head, props, valid, ref, _ = roi_pair
    sf = np.array([[2., 2., 2., 2.], [1.5, 1.25, 1.5, 1.25]], np.float32)
    kw = dict(score_thr=0.05, iou_thr=0.5, max_per_img=100)
    rj = jax.jit(lambda *a: jhead.get_bboxes(*a, **kw))(
        jnp.asarray(props), jnp.asarray(valid), ref[0], ref[1],
        jnp.asarray(sf))
    rt = head.get_bboxes(_t(props), _t(valid), _t(ref[0]),
                         tuple(map(_t, ref[1])), scale_factors=_t(sf), **kw)
    assert int(rt.valid.sum(1).min()) >= 10
    assert_detections_equal(rt, rj)


# the float64 steps

RELU_INPUTS = ('cls_fc0', 'cls_fc1', 'reg_pre_conv0', 'reg_pre_conv1',
               'x_post', 'x_up', 'x_off_fc', 'x_cls_fc', 'y_post', 'y_up',
               'y_off_fc', 'y_cls_fc')


def linear_heads(params):
    """``params`` with every ReLU input of the SABL bbox head moved above 0
    (biases raised by 20, kernels scaled by 0.1)."""
    head = params['roi_head']['bbox_head']
    for name in RELU_INPUTS:
        head[name] = dict(kernel=head[name]['kernel'] * 0.1,
                          bias=head[name]['bias'] + 20.)
    return params

def faster_cfg():
    """tpudet's SABL Faster R-CNN test config at 5 classes, 16 sampled
    rois an image."""
    return dict(
        type='FasterRCNN',
        backbone=dict(type='ResNet', depth=18, out_indices=[0, 1, 2, 3]),
        neck=dict(type='FPN', in_channels=[64, 128, 256, 512],
                  out_channels=32, num_outs=5),
        rpn_head=dict(type='RPNHead', in_channels=32, feat_channels=32),
        roi_head=dict(type='SABLRoIHead', num_classes=NUM_CLASSES,
                      in_channels=32, num_samples=16),
        train_cfg=dict(rpn_proposal=dict(nms_pre=200, max_per_img=64)),
        test_cfg=dict(rpn=dict(nms_pre=200, max_per_img=64),
                      rcnn=dict(score_thr=0.05, nms=dict(iou_threshold=0.5),
                                max_per_img=10)))


def test_a_retinanet_train_step_matches_tpudet_in_float64():
    assert_step_matches(*drawn_step(retina_cfg(), 74)[:5], KEYS)


def test_a_faster_rcnn_train_step_matches_tpudet_in_float64():
    results = drawn_step(faster_cfg(), 75, forward_train=True,
                         adjust=linear_heads)
    assert_step_matches(*results[:5], ROI_KEYS + ('loss_rpn_cls',))
    assert results[4]['loss_bucket_reg'] > 0


@pytest.mark.parametrize('scale', [3.0, 1.7])
def test_whole_pixel_sides_take_tpudets_eager_division(scale):
    """20,000 proposals and gts with every side on a whole pixel, where a
    bucket offset can be exactly 1.0 (the neighbour rule's bound): the
    port divides by the bucket width, as tpudet's eager arithmetic does,
    and its targets equal those, labels and weights exactly. tpudet's
    jitted encode multiplies by the reciprocal instead: the labels and
    class weights it gives differ from the eager ones on such sides,
    printed here (ROADMAP.md §3 records the counts and the choice)."""
    rng = np.random.RandomState(0 if scale == 3.0 else 1)
    n = 20000
    xy = rng.randint(0, 200, (n, 2)).astype(np.float32)
    wh = rng.randint(4, 120, (n, 2)).astype(np.float32)
    props = np.concatenate([xy, xy + wh], -1)
    gxy = xy + np.round(rng.uniform(-0.4, 0.4, (n, 2)) * wh)
    gwh = np.maximum(np.round(wh * rng.uniform(0.6, 1.4, (n, 2))), 1)
    gts_ = np.concatenate([gxy, gxy + gwh], -1).astype(np.float32)
    jc, tc = JCoder(14, scale), BucketingBBoxCoder(14, scale)
    eager = jc.encode(jnp.asarray(props), jnp.asarray(gts_))
    jitted = jax.jit(jc.encode)(jnp.asarray(props), jnp.asarray(gts_))
    got = tc.encode(torch.from_numpy(props), torch.from_numpy(gts_))
    for g, r in zip(got, eager):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    diffs = tuple(int((np.asarray(j) != np.asarray(e)).sum())
                  for j, e in zip(jitted[:2], eager[:2]))
    print(f'scale {scale}: jitted vs eager labels, class weights {diffs}')
    assert diffs[1] > 0
