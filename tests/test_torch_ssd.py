"""SSD in tpudet_torch against tpudet, on the CPU: ``SSDAnchorGenerator``
(300 and 512, and the pairs tpudet refuses), ``SSDVGG`` with ``L2Norm``,
``SSDHead``'s loss with its hard-negative mining and ``get_bboxes``, and
the ``SSD`` detector of ``configs/ssd/ssd300_coco.py`` (4 classes) at 300
px, batches of 2.

Tolerances:

- anchors equal (numpy on both sides, the same float32 steps);
- the detector's pred maps within 1e-4 of each map's largest |value|
  (fp32 through VGG-16's 15 convs); SSD512's level shapes equal tpudet's,
  its last level 0 x 0 (an unpadded 4 x 4 conv on a 2 x 2 map, as flax);
- ``loss`` on tpudet's own pred maps: each term rtol 1e-5, its gradient
  with respect to the maps rtol 1e-5 (atol 1e-5 of the largest |value|),
  and the mined negatives equal: the anchors whose class logits get a
  gradient are the same set. Cases: the detector's maps with gts in one
  image and none in the other (which keeps no negative), and maps whose
  class logits are all equal, so that every negative ties and the rank's
  tie break (the anchor index, ``jnp.argsort``'s stable order) alone picks
  them;
- ``get_bboxes`` of tpudet's pred maps: the keeps equal (boxes atol 1e-3
  px, scores 1e-5), rescaled and clipped or not, and the raw softmax and
  boxes of ``with_nms=False``; end to end one-to-one;
- one train step (SGD, EMA) in float64 on both sides, 1 image at 128 px
  (levels of 16, 8, 4, 2, 0 and 0 cells; at 300 px tpudet's float64 step
  runs for minutes on a CPU): losses and the gradient norm rtol 1e-4, the
  state within 5e-3 of the change the step made.
"""
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet.config import Config as JaxConfig
from tpudet.core import anchors as janchors
from tpudet.models.builder import build_detector as jax_build_detector
from tpudet.train.optim import YoloSGDConfig as JaxSGDConfig
from tpudet.train.train_state import create_train_state as jax_create_state
from tpudet.train.train_state import make_train_step as jax_make_train_step
from tpudet_torch.apis import init_detector
from tpudet_torch.config import Config
from tpudet_torch.core import anchors as tanchors
from tpudet_torch.models.builder import build_detector
from tpudet_torch.models.dense_heads import SSD
from tpudet_torch.train.optim import YoloSGDConfig
from tpudet_torch.train.train_state import create_train_state, make_train_step
from tpudet_torch.utils.flax_import import (load_flax_variables,
                                            train_state_to_flax)

from .test_torch_backbone_neck import _max_rel, random_variables
from .test_torch_faster_rcnn import assert_one_to_one
from .test_torch_roi_head import assert_detections_equal
from .test_torch_train_step import assert_tree_close
from . import torch_fixtures  # noqa: F401  (one intra-op thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG, NUM_CLASSES = 300, 4
SIZES_300 = [(38, 38), (19, 19), (10, 10), (5, 5), (3, 3), (1, 1)]
SIZES_512 = [(64, 64), (32, 32), (16, 16), (8, 8), (4, 4), (2, 2), (0, 0)]


def ssd_cfg(config='configs/ssd/ssd300_coco.py'):
    """The config's model with 4 classes (tpudet's reading of it)."""
    cfg = JaxConfig.fromfile(os.path.join(ROOT, config))['model']
    cfg['bbox_head'] = dict(cfg['bbox_head'], num_classes=NUM_CLASSES)
    return cfg


ANCHOR_CASES = {
    '300': dict(ratio_range=(0.15, 0.9), input_size=300, sizes=SIZES_300),
    '300_voc': dict(ratio_range=(0.2, 0.9), input_size=300,
                    sizes=SIZES_300),
    '512': dict(ratio_range=(0.1, 0.9), input_size=512, sizes=SIZES_512),
    '512_015': dict(ratio_range=(0.15, 0.9), input_size=512,
                    sizes=SIZES_512),
}


def _anchor_kw(case):
    c = ANCHOR_CASES[case]
    if c['input_size'] == 300:
        strides = [8, 16, 32, 64, 100, 300]
        ratios = [[2], [2, 3], [2, 3], [2, 3], [2], [2]]
    else:
        strides = [8, 16, 32, 64, 128, 256, 512]
        ratios = [[2], [2, 3], [2, 3], [2, 3], [2, 3], [2], [2]]
    return dict(strides=strides, ratios=ratios,
                basesize_ratio_range=c['ratio_range'],
                input_size=c['input_size'], scale_major=False)


@pytest.mark.parametrize('case', list(ANCHOR_CASES))
def test_ssd_anchor_generator_equals_tpudets(case):
    kw = _anchor_kw(case)
    ref = janchors.SSDAnchorGenerator(**kw)
    got = tanchors.SSDAnchorGenerator(**kw)
    assert got.base_sizes == ref.base_sizes
    assert got.num_base_anchors == ref.num_base_anchors
    assert got.num_base_anchors[:2] == [4, 6]
    for g, r in zip(got.base_anchors, ref.base_anchors):
        assert g.dtype == r.dtype and g.tobytes() == r.tobytes()
    sizes = ANCHOR_CASES[case]['sizes']
    for g, r in zip(got.grid_anchors(sizes), ref.grid_anchors(sizes)):
        assert g.shape == r.shape and g.tobytes() == r.tobytes()
    # the big square anchor sits in slot 1: sqrt(min * max) wide
    a = got.base_anchors[0]
    assert a[1, 2] - a[1, 0] > a[0, 2] - a[0, 0]


@pytest.mark.parametrize('size,ratio_range', [(300, (0.1, 0.9)),
                                              (512, (0.2, 0.9))])
def test_ssd_anchor_generator_refuses_tpudets_unlisted_pairs(size,
                                                             ratio_range):
    kw = _anchor_kw('300' if size == 300 else '512')
    kw['basesize_ratio_range'] = ratio_range
    for module in (janchors, tanchors):
        with pytest.raises(ValueError, match='unsupported SSD config'):
            module.SSDAnchorGenerator(**kw)


def _img(seed, b=2):
    return np.random.RandomState(seed).uniform(
        -1.5, 1.5, (b, IMG, IMG, 3)).astype(np.float32)


@pytest.fixture(scope='module')
def ssd_pair():
    cfg = ssd_cfg()
    jmodel = jax_build_detector(cfg)
    variables = jax.tree.map(np.asarray, random_variables(jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3))),
        3))
    img = _img(4)
    det = init_detector(cfg, variables=variables, device='cpu',
                        dtype=torch.float32)
    ref = jax.jit(jmodel.apply)(variables, jnp.asarray(img))
    got = det.forward(img)
    return cfg, jmodel, variables, det, img, ref, got


def test_ssd300_pred_maps_match_tpudet(ssd_pair):
    _, _, variables, det, _, ref, got = ssd_pair
    assert type(det.model) is SSD and det.model.neck is None
    assert set(variables['params']['backbone']) >= {'l2_norm', 'fc6',
                                                    'extra7'}
    for g_lvls, r_lvls in zip(got, ref):
        assert [tuple(g.shape[1:3]) for g in g_lvls] == SIZES_300
        for g, r in zip(g_lvls, r_lvls):
            assert tuple(g.shape) == np.asarray(r).shape
            assert _max_rel(g.numpy(), np.asarray(r)) <= 1e-4
    assert got[0][0].shape[-1] == 4 * (NUM_CLASSES + 1)
    assert got[1][1].shape[-1] == 6 * 4


def test_ssd512_levels_match_tpudets_shapes():
    cfg = ssd_cfg('configs/ssd/ssd512_coco.py')
    jmodel = jax_build_detector(cfg)
    x = jnp.zeros((1, 512, 512, 3))
    ref = jax.eval_shape(lambda v: jmodel.apply(v, x), jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0), x))
    with torch.device('meta'):
        model = build_detector(Config(dict(model=cfg))['model'])
        got = model(torch.zeros(1, 512, 512, 3))
    for g_lvls, r_lvls in zip(got, ref):
        assert [tuple(g.shape) for g in g_lvls] == [r.shape for r in r_lvls]
    assert got[0][-1].shape[1:3] == (0, 0)


def _gts(seed, b=2, g=6):
    """gts in image 0 only, sides 20-200 px (every level's anchors)."""
    rng = np.random.RandomState(seed)
    boxes = np.zeros((b, g, 4), np.float32)
    valid = np.zeros((b, g), bool)
    wh = rng.uniform(20, 200, (g, 2))
    xy = rng.uniform(0, 1, (g, 2)) * (IMG - wh)
    boxes[0] = np.concatenate([xy, xy + wh], -1)
    valid[0] = True
    labels = rng.randint(0, NUM_CLASSES, (b, g)).astype(np.int32)
    return boxes, labels, valid


def _tied_maps(ref):
    """The pred maps with every class logit row one constant vector (so
    every negative's loss ties) and the deltas as they are."""
    row = np.array([0.3, -0.2, 0.1, 0.4, 1.0], np.float32)
    cls = tuple(np.broadcast_to(np.tile(row, np.asarray(c).shape[-1] //
                                        len(row)), np.asarray(c).shape
                                ).copy() for c in ref[0])
    return cls, tuple(np.asarray(r) for r in ref[1])


@pytest.mark.parametrize('maps', ['forward', 'tied'])
def test_ssd_loss_mines_tpudets_negatives(ssd_pair, maps):
    _, jmodel, _, det, _, ref, _ = ssd_pair
    ref = (tuple(np.asarray(c) for c in ref[0]),
           tuple(np.asarray(r) for r in ref[1]))
    if maps == 'tied':
        ref = _tied_maps(ref)
    boxes, labels, valid = _gts(5)
    keys = ('loss_cls', 'loss_bbox')

    def total(preds):
        out = jmodel.loss(preds, jnp.asarray(boxes), jnp.asarray(labels),
                          jnp.asarray(valid))
        return sum(out[k] for k in keys), out

    (_, jl), jg = jax.jit(jax.value_and_grad(total, has_aux=True))(
        jax.tree.map(jnp.asarray, ref))
    tpreds = tuple(tuple(torch.tensor(a, requires_grad=True) for a in lvls)
                   for lvls in ref)
    tl = det.model.loss(tpreds, *(torch.from_numpy(a)
                                  for a in (boxes, labels, valid)))
    sum(tl[k] for k in keys).backward()
    for k in keys + ('num_gts',):
        np.testing.assert_allclose(float(tl[k].detach()), float(jl[k]),
                                   rtol=1e-5, err_msg=k)
    kept_t, kept_j = [], []
    for t_lvls, r_lvls, per in zip(tpreds, jg, (NUM_CLASSES + 1, 4)):
        for t, r in zip(t_lvls, r_lvls):
            r = np.asarray(r)
            np.testing.assert_allclose(t.grad.numpy(), r, rtol=1e-5,
                                       atol=1e-5 * np.abs(r).max())
            if per == NUM_CLASSES + 1:
                b = r.shape[0]
                kept_t.append((t.grad.numpy().reshape(b, -1, per) != 0
                               ).any(-1))
                kept_j.append((r.reshape(b, -1, per) != 0).any(-1))
    kept_t, kept_j = np.concatenate(kept_t, 1), np.concatenate(kept_j, 1)
    np.testing.assert_array_equal(kept_t, kept_j)
    # image 1 has no gt: no positive and no negative is kept
    assert kept_t[0].sum() > 0 and kept_t[1].sum() == 0
    if maps == 'tied':
        # the kept negatives are the first 3 * pos by anchor index
        from tpudet_torch.core.assigners import max_iou_assign_batch
        anchors = det.model.bbox_head._anchors(tpreds[0])
        codes = max_iou_assign_batch(anchors, torch.from_numpy(boxes),
                                     torch.from_numpy(valid), 0.5, 0.5)[0]
        pos = codes >= 0
        negs = torch.nonzero(codes == -1)[:, 0].numpy()
        want = pos.numpy().copy()
        want[negs[:3 * int(pos.sum())]] = True
        np.testing.assert_array_equal(kept_t[0], want)


@pytest.mark.parametrize('rescale', [False, True])
def test_get_bboxes_matches_tpudet(ssd_pair, rescale):
    _, jmodel, _, det, img, ref, got = ssd_pair
    kw, tkw = {}, {}
    if rescale:
        sf = np.array([[2., 2., 2., 2.], [1.5, 1.25, 1.5, 1.25]], np.float32)
        hw = np.array([[IMG, IMG], [250, 200]], np.float32)
        kw = dict(scale_factors=jnp.asarray(sf),
                  img_shape=(jnp.asarray(hw[:, :1]), jnp.asarray(hw[:, 1:])))
        tkw = dict(scale_factors=torch.from_numpy(sf),
                   img_shape=(torch.from_numpy(hw[:, :1]),
                              torch.from_numpy(hw[:, 1:])))
    rj = jax.jit(lambda maps, kw: jmodel.get_bboxes(maps, **kw))(ref, kw)
    tref = tuple(tuple(torch.tensor(np.asarray(a)) for a in lvls)
                 for lvls in ref)
    rt = det.model.get_bboxes(tref, **tkw)
    assert int(rt.valid.sum(1).min()) >= 20
    assert_detections_equal(rt, rj)
    assert_one_to_one(det.model.get_bboxes(got, **tkw), rj, 1e-3)
    raw_j = jmodel.bbox_head.get_bboxes(ref, with_nms=False, **kw)
    raw_t = det.model.bbox_head.get_bboxes(tref, with_nms=False, **tkw)
    for g, r in zip(raw_t, raw_j):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-4)
    assert raw_t[1].shape[-1] == NUM_CLASSES + 1  # the background column


OPT = dict(lr=0.01, momentum=0.9, weight_decay=5e-4, nesterov=False,
           total_steps=50, warmup_iters=3, steps_per_epoch=0,
           grad_clip_norm=10.0, lr_weight_warmup_ratio=1.0,
           lr_bias_warmup_ratio=1.0, momentum_warmup_ratio=1.0)
STEP_IMG = 128
EMA = dict(ema_momentum_base=0.9999, ema_warm_up=4, ema_interval=1)


def test_a_train_step_matches_tpudet_in_float64():
    """One step of tpudet's ``make_train_step`` (x64) against the port's
    on the float64 model, from tpudet's init (VGG's convs ``he_normal``,
    the head ``xavier_uniform``, L2Norm's scale 20), 1 image of STEP_IMG
    px with 3 gts, the learning rates at their base (no warm-up ramp)."""
    cfg = ssd_cfg()
    jmodel = jax_build_detector(cfg)
    jopt = JaxSGDConfig(**OPT)
    state0 = jax.device_get(jax.jit(
        lambda key, x: jax_create_state(jmodel, key, x, jopt))(
            jax.random.PRNGKey(0), jnp.zeros((1, STEP_IMG, STEP_IMG, 3))))
    state0 = jax.tree.map(lambda a: np.asarray(a, np.float64)
                          if a.dtype == np.float32 else a, state0)
    batch = dict(
        img=np.random.RandomState(7).uniform(
            -1.5, 1.5, (1, STEP_IMG, STEP_IMG, 3)),
        gt_bboxes=np.array([[[10, 10, 60, 70], [30, 5, 100, 90],
                             [0, 20, 120, 128]]], np.float32),
        gt_labels=np.array([[0, 1, 3]], np.int32),
        gt_valid=np.ones((1, 3), bool))
    with jax.enable_x64(True):
        jstate, jm = jax.jit(jax_make_train_step(jmodel, jopt, **EMA))(
            state0, jax.tree.map(jnp.asarray, batch))
        jstate, jm = jax.device_get((jstate, jm))
    model = build_detector(cfg)
    load_flax_variables(model, {'params': state0.params,
                                'batch_stats': state0.batch_stats})
    model.double()
    model.dtype = torch.float64
    opt = YoloSGDConfig(**OPT)
    state, tm = make_train_step(model, opt, **EMA)(
        create_train_state(model, opt),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ('loss', 'loss_cls', 'loss_bbox', 'num_gts', 'grad_norm', 'lr',
              'momentum'):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   err_msg=k)
    assert math.isfinite(float(jm['loss'])) and float(jm['grad_norm']) > 0
    tstate = train_state_to_flax(state, model)
    for what in ('params', 'ema_params'):
        assert_tree_close(getattr(tstate, what), getattr(jstate, what),
                          getattr(state0, what), what)
    assert_tree_close(tstate.opt_state.momentum_buf,
                      jstate.opt_state.momentum_buf,
                      state0.opt_state.momentum_buf, 'momentum_buf')
    # the L2Norm scale learns (it starts at 20)
    assert (state0.params['backbone']['l2_norm']['scale'] == 20.).all()
    assert not np.array_equal(tstate.params['backbone']['l2_norm']['scale'],
                              state0.params['backbone']['l2_norm']['scale'])
