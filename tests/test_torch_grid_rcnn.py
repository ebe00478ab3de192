"""Grid R-CNN (``GridHead``, ``GridRoIHead``, ``GridRCNN``) in
tpudet_torch against tpudet, on the CPU.

- ``GridHead`` alone (narrowed: 8 point channels, 2 convs) on random
  (N, 14, 14, C) features with random, asymmetric raw transposed-conv
  kernels (a kernel taken unflipped, or its groups in another order,
  shows), in train mode (fused and unfused heatmaps) and in eval mode, and
  its input gradient: within 1e-5 of each output's largest |value| (fp32);
- ``get_targets`` of random rois and gts in float64 and fp32 equal to
  tpudet's (the circles, the floor of each point's place, the zero maps
  of small rois); ``refine_bboxes`` of random heatmaps rtol 1e-6, and on
  a tie between two maxima the first one votes, as ``jnp.argmax``;
- the training jitter (a ``sin`` hash): within 1e-3 px of tpudet's where
  the two packages' fp32 sines agree, and the count of boxes where an ulp
  of ``sin`` moves them further (tpudet's jitted hash against its eager
  one too);
- ``grid_train``'s selection (the first ``max_num_grid`` slots,
  positives first, the gts recovered) and targets, and ``grid_loss`` and
  its gradients in float64 on random heatmaps: rtol 1e-6 (the gradients'
  atol 1e-6 of the largest);
- the detector at tpudet's test config (ResNet-18, a 64-channel FPN, 4
  classes) with 20 detections at most, 128 px: ``get_bboxes`` (zero
  deltas, the proposals scored) keeps equal on tpudet's outputs;
  ``refine_boxes`` of the detections within 1e-3 px;
- one float64 train step from the same random weights, 2 images of 64 px,
  2 grid rois an image and the grid heads narrowed to a 2 x 2 grid and 2
  convs of 36 channels (XLA compiles tpudet's float64 step for seconds a
  transition),
  the jitter swapped for a smooth one in both packages (the port's rois
  are fp32 in a float64 run, and the hash magnifies their rounding), every
  ReLU input of the RoI heads above 0: the losses and the gradient norm
  rtol 1e-4, the state within 5e-3 of the step's change.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet.models.roi_heads import grid_roi_head as jgrid
from tpudet.models.roi_heads.grid_roi_head import GridHead as JGridHead
from tpudet.models.roi_heads.grid_roi_head import GridRoIHead as JGridRoIHead
from tpudet_torch.apis import init_detector
from tpudet_torch.models.builder import build_detector
from tpudet_torch.models.roi_heads import grid_roi_head
from tpudet_torch.models.roi_heads.grid_roi_head import (GridHead, GridRCNN,
                                                         GridRoIHead, jitter)
from tpudet_torch.utils.flax_import import (load_flax_variables,
                                            random_flax_variables)

from .test_models.test_pisa_grid_rcnn import grid_cfg
from .test_torch_atss_gfl import assert_step_matches, gts, images
from .test_torch_backbone_neck import random_variables
from .test_torch_reppoints import drawn_step
from .test_torch_roi_head import CH, _feats, _proposals, _t
from .test_torch_roi_head import assert_detections_equal
from . import torch_fixtures  # noqa: F401  (one intra-op thread)

NUM_CLASSES = 3


def random_rois(rng, n, lo=2., hi=60.):
    xy = rng.uniform(0, 100, (n, 2))
    return np.concatenate([xy, xy + rng.uniform(lo, hi, (n, 2))], -1)


# the grid head alone

@pytest.mark.parametrize('train', [True, False])
def test_grid_head_and_its_input_gradient_match_tpudet(train):
    x = np.random.RandomState(40).randn(6, 14, 14, CH).astype(np.float32)
    kw = dict(num_convs=2, point_feat_channels=8)
    jhead = JGridHead(**kw)
    variables = jax.tree.map(np.asarray, random_variables(jax.eval_shape(
        lambda k, a: jhead.init(k, a, True), jax.random.PRNGKey(0),
        jnp.asarray(x)), 41))
    k = variables['params']['deconv1_kernel']
    assert k.shape == (4, 4, 8, 72)
    assert not np.allclose(k, k[::-1]) and not np.allclose(k, k[:, ::-1])
    head = GridHead(CH, **kw)
    load_flax_variables(head, variables)
    head.train(train)
    w = [np.random.RandomState(42 + i).randn(6, 28, 28, 9).astype(np.float32)
         for i in range(2)]

    def jtotal(inp):
        outs = jhead.apply(variables, inp, train)
        return sum(jnp.sum(o * wi) for o, wi in zip(outs, w)), outs
    (_, ref), jg = jax.jit(jax.value_and_grad(jtotal, has_aux=True))(
        jnp.asarray(x))
    tx = _t(x).requires_grad_()
    got = head(tx)
    sum((o * _t(wi)).sum() for o, wi in zip(got, w)).backward()
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert tuple(g.shape) == r.shape == (6, 28, 28, 9)
        np.testing.assert_allclose(g.detach().numpy(), r,
                                   atol=1e-5 * np.abs(r).max())
    assert train != np.allclose(np.asarray(ref[0]), np.asarray(ref[1]))
    r = np.asarray(jg)
    np.testing.assert_allclose(tx.grad.numpy(), r, atol=1e-5 * np.abs(r).max())


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_grid_targets_equal_tpudets(dtype):
    rng = np.random.RandomState(43)
    rois = random_rois(rng, 60).astype(dtype)
    rois[:3, 2:] = rois[:3, :2] + 1.2  # expanded sides <= 3: zero maps
    gts_ = (rois + rng.uniform(-0.3, 0.3, (60, 4)) *
            (rois[:, 2:] - rois[:, :2])[:, [0, 1, 0, 1]]).astype(dtype)
    with jax.enable_x64(dtype == np.float64):
        ref = np.asarray(JGridHead().get_targets(jnp.asarray(rois),
                                                 jnp.asarray(gts_)))
    got = GridHead().get_targets(torch.from_numpy(rois),
                                 torch.from_numpy(gts_))
    assert got.shape == (60, 28, 28, 9)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ref[:3].sum() == 0 and ref[3:].sum(axis=(1, 2)).min() > 0


def test_refine_bboxes_matches_tpudet_and_takes_the_first_maximum():
    rng = np.random.RandomState(44)
    boxes = random_rois(rng, 12)
    heat = rng.randn(12, 28, 28, 9) * 3
    heat[0, 5, 7, 0] = heat[0, 20, 3, 0] = 50.  # a tie: row 5 votes
    with jax.enable_x64(True):
        ref = np.asarray(JGridHead().refine_bboxes(jnp.asarray(boxes),
                                                   jnp.asarray(heat)))
    head = GridHead()
    got = head.refine_bboxes(torch.from_numpy(boxes), torch.from_numpy(heat))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6)
    # the tie: point 0 (x index 0, y index 0) votes at row 5, column 7
    moved = heat.copy()
    moved[0, 20, 3, 0] = -50.
    alone = head.refine_bboxes(torch.from_numpy(boxes[:1]),
                               torch.from_numpy(moved[:1]))
    np.testing.assert_allclose(got.numpy()[0], alone.numpy()[0], rtol=1e-12)


def test_jitter_matches_tpudets_where_the_sines_agree():
    """tpudet's hash takes ``sin`` of the coordinates times up to 78 in
    fp32, then keeps the fraction of its sum times 43758.5453: an ulp of
    ``sin`` moves the offsets by up to a wrap. torch's fp32 ``sin`` and
    XLA's part by an ulp on some of these 1600 products, and the boxes
    they feed move; the boxes whose four sines agree are tpudet's within
    1e-3 px. The counts (sines apart, boxes apart, tpudet's jitted hash
    against its eager one) are printed; ROADMAP.md §3 records them."""
    rng = np.random.RandomState(45)
    rois = random_rois(rng, 400).astype(np.float32)
    jhead = JGridRoIHead(num_classes=NUM_CLASSES, in_channels=CH)
    eager = np.asarray(jhead._jitter(jnp.asarray(rois)))
    jitted = np.asarray(jax.jit(jhead._jitter)(jnp.asarray(rois)))
    got = jitter(torch.from_numpy(rois)).numpy()
    seed = rois * np.asarray(grid_roi_head.JITTER_SEED, np.float32)
    alike = np.all(np.asarray(jnp.sin(jnp.asarray(seed))) ==
                   torch.sin(torch.from_numpy(seed)).numpy(), -1)
    np.testing.assert_allclose(got[alike], eager[alike], atol=1e-3)
    far = lambda a, b: int((np.abs(a - b).max(-1) > 1e-3).sum())  # noqa
    sines = int((np.asarray(jnp.sin(jnp.asarray(seed))) !=
                 torch.sin(torch.from_numpy(seed)).numpy()).sum())
    print(f'sines apart {sines} of 1600; boxes further than 1e-3 px: port '
          f'vs eager {far(got, eager)}, tpudet jitted vs eager '
          f'{far(jitted, eager)} of 400')
    assert far(got, eager) <= int((~alike).sum()) and alike.mean() > 0.8


# the RoI head's grid branch

@pytest.fixture(scope='module')
def grid_batch():
    """The head test's features and rois, sampled by the port (64 slots an
    image), and a GridRoIHead pair (2 convs, 8 point channels) on random
    weights."""
    feats = _feats(0)
    props, valid = _proposals(1)
    boxes, labels, gvalid = gts(3, num_classes=NUM_CLASSES)
    jhead = JGridRoIHead(num_classes=NUM_CLASSES, in_channels=CH,
                         max_num_grid=24)
    head = GridRoIHead(num_classes=NUM_CLASSES, in_channels=CH,
                       max_num_grid=24)
    head.grid_head = GridHead(CH, num_convs=2, point_feat_channels=8)
    samp = head.sample_rois(_t(props), _t(valid), _t(boxes), _t(labels),
                            _t(gvalid), num_samples=64)
    return feats, boxes, gvalid, jhead, head, samp


def test_grid_train_selection_and_targets_match_tpudet(grid_batch):
    feats, boxes, gvalid, jhead, head, samp = grid_batch
    rois, sampled, labels, targets, pos = samp
    order = torch.argsort((~pos).to(torch.int32), dim=1, stable=True)[:, :24]
    pos_k = torch.gather(pos, 1, order)
    assert int(pos_k[0].sum()) == min(int(pos[0].sum()), 24)
    rois_k = torch.gather(rois, 1, order[..., None].expand(-1, -1, 4))
    tgt_k = torch.gather(targets, 1, order[..., None].expand(-1, -1, 4))
    jit_k = torch.where(pos_k[..., None], jitter(rois_k), rois_k)
    gt_k = head.bbox_coder.decode(rois_k, tgt_k)
    # the recovered gts: each positive's own gt, within 1e-3 px
    for b in range(2):
        for box, p in zip(gt_k[b].numpy(), pos_k[b].numpy()):
            if p:
                assert np.abs(boxes[b] - box).max(-1).min() < 1e-3
    ref_t = np.asarray(jax.vmap(lambda r, g: jgrid.GridHead().get_targets(
        r, g, 1.0))(jnp.asarray(jit_k.numpy()), jnp.asarray(gt_k.numpy())))
    got_t = head.grid_head.get_targets(jit_k, gt_k)
    np.testing.assert_array_equal(got_t.numpy(), ref_t)
    assert got_t[pos_k].sum() > 0


def test_grid_loss_and_gradients_match_tpudet_in_float64(grid_batch):
    *_, jhead, head, samp = grid_batch
    pos = samp[4][:, :24].numpy()
    rng = np.random.RandomState(46)
    heat = [rng.randn(2, 24, 28, 28, 9) * 2 for _ in range(2)]
    tgt = (rng.rand(2, 24, 28, 28, 9) > 0.97).astype(np.float64)
    with jax.enable_x64(True):
        def total(f, u):
            return jhead.grid_loss(f, u, jnp.asarray(tgt),
                                   jnp.asarray(pos))['loss_grid']
        jl, jg = jax.value_and_grad(total, argnums=(0, 1))(
            *map(jnp.asarray, heat))
    th = [torch.tensor(h).requires_grad_() for h in heat]
    tl = head.grid_loss(*th, torch.from_numpy(tgt), torch.from_numpy(pos))
    tl['loss_grid'].backward()
    np.testing.assert_allclose(float(tl['loss_grid'].detach()), float(jl),
                               rtol=1e-6)
    for t, r in zip(th, jg):
        r = np.asarray(r)
        np.testing.assert_allclose(t.grad.numpy(), r, rtol=1e-6,
                                   atol=1e-6 * np.abs(r).max())


# the detector

def cfg(max_per_img=20):
    """tpudet's Grid R-CNN test config (``tests/test_models/
    test_pisa_grid_rcnn.py``) at 20 detections an image."""
    c = grid_cfg()
    c['test_cfg']['rcnn'] = dict(c['test_cfg']['rcnn'],
                                 max_per_img=max_per_img)
    return c


@pytest.fixture(scope='module')
def detector_pair():
    c = cfg()
    jmodel = jax_build(c)
    variables = random_flax_variables(build_detector(c), 47)
    variables['params']['roi_head']['bbox_head']['fc_cls']['kernel'] *= 100
    det = init_detector(c, variables=variables, device='cpu',
                        dtype=torch.float32)
    img = images(47)
    ref = jax.jit(jmodel.apply)(variables, jnp.asarray(img))
    return jmodel, variables, det, img, ref


def jax_build(c):
    from tpudet.models.builder import build_detector as jax_build_detector
    return jax_build_detector(c)


def test_get_bboxes_scores_the_proposals_as_tpudet(detector_pair):
    jmodel, _, det, _, ref = detector_pair
    rj = jax.jit(jmodel.get_bboxes)(ref)
    rt = det.model.get_bboxes(tuple(_t(r) for r in ref))
    assert int(rt.valid.sum(1).min()) >= 10
    assert_detections_equal(rt, rj)
    # the boxes are proposals (zero deltas): each one of the call's
    props = np.asarray(ref[0])
    for b in range(2):
        for box in rt.bboxes[b][rt.valid[b]].numpy():
            assert np.abs(props[b] - box).max(-1).min() < 1e-3


def test_refine_boxes_matches_tpudet(detector_pair):
    jmodel, variables, det, img, ref = detector_pair
    res = jax.jit(jmodel.get_bboxes)(ref)
    rj = jax.jit(lambda v, x, b, m: jmodel.apply(
        v, x, b, m, method='refine_boxes'))(
            variables, jnp.asarray(img), res.bboxes, res.valid)
    x = torch.from_numpy(img)
    with torch.no_grad():
        rt = det.model.refine_boxes(x, _t(res.bboxes), _t(res.valid))
        again = det.model.refine_boxes(x, _t(res.bboxes), _t(res.valid),
                                       feats=det.model.extract_feat(x))
    assert torch.equal(rt, again)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-3)
    valid = np.asarray(res.valid)
    assert np.abs(rt.numpy() - np.asarray(res.bboxes))[valid].max() > 0.1


def smooth_jitter(boxes, amplitude=0.15):
    """A jitter without the hash, for the float64 step: both packages move
    each box by 0.1 of its size times a smooth function of it."""
    return boxes + 0.1 * (boxes[..., 2:3] - boxes[..., 0:1]) * \
        amplitude * jnp_or_torch(boxes).sin(boxes * 0.05)


def jnp_or_torch(x):
    return jnp if isinstance(x, jax.Array) else torch


def test_a_train_step_matches_tpudet_in_float64(monkeypatch):
    monkeypatch.setattr(JGridRoIHead, '_jitter',
                        lambda self, b: smooth_jitter(b))
    monkeypatch.setattr(grid_roi_head, 'jitter', smooth_jitter)
    # both packages' grid heads narrowed to a 2 x 2 grid and 2 convs of 4 x
    # 9 channels (the RoI heads build them with the defaults, 8 convs of 9
    # x 64, and 48 transitions: seconds of XLA's compile each)
    narrow = dict(num_convs=2, point_feat_channels=9)
    monkeypatch.setattr(jgrid, 'GridHead', functools.partial(
        jgrid.GridHead, **narrow))
    monkeypatch.setattr(grid_roi_head, 'GridHead', functools.partial(
        grid_roi_head.GridHead, **narrow))
    c = cfg(10)
    c['neck'] = dict(c['neck'], out_channels=32)
    c['rpn_head'] = dict(c['rpn_head'], in_channels=32, feat_channels=32)
    c['roi_head'] = dict(c['roi_head'], in_channels=32, num_samples=16,
                         max_num_grid=2, grid_points=4)
    results = drawn_step(c, 48, forward_train=True, adjust=linear_grid)
    assert_step_matches(*results[:5], ('loss_cls', 'loss_grid',
                                       'loss_rpn_cls'))
    assert isinstance(results[5], GridRCNN) and results[4]['loss_grid'] > 0


def linear_grid(params):
    """Every ReLU input of the RoI heads above 0: the 2-FC head's FCs and
    the grid head's GroupNorms (scale 0.1, bias 20), the layers after them
    scaled down."""
    params = jax.tree.map(np.array, params)
    head = params['roi_head']['bbox_head']
    head['shared_fc0']['bias'] += 30.
    head['shared_fc1']['kernel'] *= 0.1
    head['shared_fc1']['bias'] += 20.
    for out in ('fc_cls', 'fc_reg'):
        head[out]['kernel'] *= 0.05
    grid = params['roi_head']['grid_head']
    for k, v in grid.items():
        if k.startswith('gn') or k == 'dgn':
            v['scale'] = np.full_like(v['scale'], 0.1)
            v['bias'] = v['bias'] + 20.
    grid['deconv2_kernel'] = grid['deconv2_kernel'] * 0.01
    return params
