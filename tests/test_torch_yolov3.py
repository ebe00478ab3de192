"""YOLOv3 in tpudet_torch against tpudet, on the CPU in fp32:
``YOLOAnchorGenerator`` (with ``responsible_flags``) and YOLOv4's
generator built on it, ``YOLOBBoxCoder``, ``grid_assign_batch``, and the
YOLOv3 detector (Darknet-53 at full width, tpudet's test widths for the
neck and head, ``tests/test_models/test_yolov3.py``'s ``v3_cfg``, 4
classes, 96 px, batches of 2).

Tolerances:

- anchors, responsibility flags and assignment codes equal (the IoUs
  round alike on the CPU); YOLOv4's grids bit-equal to tpudet's;
- the coder within 1e-6 (rtol and atol), its clips and the decode's
  clamp at 8 included;
- pred maps within 1e-4 of each map's largest |value|;
- ``loss`` on tpudet's own pred maps, each term and its gradient with
  respect to the pred maps rtol 1e-5 (``'sum'`` and ``'mean'``
  reductions; gts in some images, in none); on each package's own
  forward rtol 1e-4;
- ``get_bboxes`` of tpudet's pred maps: the keeps equal (boxes atol 1e-3
  px, scores 1e-5), rescaled or not, and the raw candidates of
  ``with_nms=False``; end to end one-to-one, at least 99 % of tpudet's;
- one train step (SGD, warm-up, EMA; BatchNorm in train mode): losses
  and the gradient norm rtol 1e-4, the state within 5e-3 of the change the
  step made (``test_torch_train_step.py``'s yardstick);
- ``train_detector`` (2 steps on the plain loader) and the test CLI on a
  narrowed ``configs/yolo/yolov3_d53_mstrain-608_273e_coco.py``, the
  CLI's report equal to the API's within 1e-6.
"""
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet.core import anchors as janchors
from tpudet.core import assigners as jassign
from tpudet.core.bbox import YOLOBBoxCoder as JaxYOLOBBoxCoder
from tpudet.models.builder import build_detector as jax_build_detector
from tpudet.models.dense_heads.yolov3_head import V3_BASE_SIZES
from tpudet.train.optim import YoloSGDConfig as JaxSGDConfig
from tpudet.train.train_state import create_train_state as jax_create_state
from tpudet.train.train_state import make_train_step as jax_make_train_step
from tpudet_torch.apis import init_detector
from tpudet_torch.config import Config
from tpudet_torch.core import anchors as tanchors
from tpudet_torch.core.assigners import grid_assign_batch
from tpudet_torch.core.bbox import YOLOBBoxCoder
from tpudet_torch.models.builder import build_detector
from tpudet_torch.models.detectors import YOLOV3
from tpudet_torch.train.optim import YoloSGDConfig
from tpudet_torch.train.train_state import make_train_step
from tpudet_torch.utils.flax_import import (train_state_from_flax,
                                            train_state_to_flax)

from .test_models.test_yolov3 import v3_cfg
from .test_torch_backbone_neck import _max_rel, random_variables
from .test_torch_faster_rcnn import assert_one_to_one
from .test_torch_roi_head import assert_detections_equal
from .test_torch_test_flow import CLASSES, NO_RESIZE, _write_set
from .test_torch_train_step import assert_tree_close, tiny_batch
from . import torch_fixtures  # noqa: F401  (one intra-op thread)

IMG, NUM_CLASSES = 96, 4
STRIDES = (32, 16, 8)
SIZES = [(IMG // s, IMG // s) for s in STRIDES]


def _gts(seed, b=3, g=5):
    """Padded gts: 5, 2 and 0 in the three images; sides 4-80 px, so they
    fall to every level; one box twice (a tie between gts)."""
    rng = np.random.RandomState(seed)
    boxes = np.zeros((b, g, 4), np.float32)
    valid = np.zeros((b, g), bool)
    for i, n in enumerate((g, 2, 0)[:b]):
        wh = rng.uniform(4, 80, (n, 2))
        xy = rng.uniform(0, 1, (n, 2)) * (IMG - wh)
        boxes[i, :n] = np.concatenate([xy, xy + wh], -1)
        valid[i, :n] = True
    boxes[0, 1] = boxes[0, 0]
    labels = rng.randint(0, NUM_CLASSES, (b, g)).astype(np.int32)
    return boxes, labels, valid


def test_yolo_anchor_generator_matches_tpudet():
    kw = dict(strides=list(STRIDES), base_sizes=[list(b) for b in
                                                 V3_BASE_SIZES])
    ref, got = janchors.YOLOAnchorGenerator(**kw), \
        tanchors.YOLOAnchorGenerator(**kw)
    assert got.num_base_anchors == ref.num_base_anchors == [3, 3, 3]
    for g, r in zip(got.base_anchors, ref.base_anchors):
        np.testing.assert_array_equal(g, r)
    for g, r in zip(got.grid_anchors(SIZES), ref.grid_anchors(SIZES)):
        np.testing.assert_array_equal(g, r)
    boxes, _, valid = _gts(1)
    for g, r in zip(got.responsible_flags(SIZES, boxes[0][valid[0]]),
                    ref.responsible_flags(SIZES, boxes[0][valid[0]])):
        np.testing.assert_array_equal(g, r)
        assert g.any()
    # YOLOv4's generator is YOLOv3's: its grids stay tpudet's bit for bit
    v4 = dict(strides=[8, 16, 32], base_sizes=[
        [(12, 16), (19, 36), (40, 28)], [(36, 75), (76, 55), (72, 146)],
        [(142, 110), (192, 243), (459, 401)]])
    got4 = tanchors.YOLOV4AnchorGenerator(**v4)
    ref4 = janchors.YOLOV4AnchorGenerator(**v4)
    sizes = [(8, 8), (4, 4), (2, 2)]
    for g, r in zip(got4.grid_anchors(sizes), ref4.grid_anchors(sizes)):
        assert g.dtype == r.dtype and g.tobytes() == r.tobytes()
    for g, r in zip(got4.base_anchor_wh(), ref4.base_anchor_wh()):
        assert g.tobytes() == r.tobytes()


def test_yolo_bbox_coder_matches_tpudet():
    rng = np.random.RandomState(2)
    xy = rng.uniform(0, 200, (64, 2))
    anchors = np.concatenate([xy, xy + rng.uniform(5, 120, (64, 2))],
                             -1).astype(np.float32)
    gts = anchors + rng.uniform(-40, 40, (64, 4)).astype(np.float32)
    gts[:, 2:] = np.maximum(gts[:, 2:], gts[:, :2] + 1e-3)
    gts[:4, 2:] = gts[:4, :2]  # zero width and height: the eps clip
    gts[4:8] += 100.  # centres far out of the cell: the xy clip
    stride = 16.
    ref = np.asarray(JaxYOLOBBoxCoder().encode(
        jnp.asarray(anchors), jnp.asarray(gts), stride))
    got = YOLOBBoxCoder().encode(torch.from_numpy(anchors),
                                 torch.from_numpy(gts), stride).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    assert (got[:4, 2:] == np.log(np.float32(1e-6))).all()
    assert (got[4:8, :2] == np.float32(1 - 1e-6)).any()
    pred = np.concatenate([rng.uniform(0, 1, (64, 2)),
                           rng.uniform(-3, 3, (64, 2))], -1).astype(
                               np.float32)
    pred[:4, 2:] = 12.  # over the clamp at 8
    ref = np.asarray(JaxYOLOBBoxCoder.decode(jnp.asarray(anchors),
                                             jnp.asarray(pred), stride))
    got = YOLOBBoxCoder.decode(torch.from_numpy(anchors),
                               torch.from_numpy(pred), stride).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-4)
    assert np.isfinite(got).all()


def test_grid_assign_batch_matches_tpudet():
    gen = tanchors.YOLOAnchorGenerator(
        list(STRIDES), [list(b) for b in V3_BASE_SIZES])
    anchors = np.concatenate(gen.grid_anchors(SIZES))
    boxes, _, valid = _gts(3)
    rng = np.random.RandomState(4)
    responsible = rng.rand(3, len(anchors)) < 0.3
    for args in ((0.5, 0.5, 0.0), (0.3, 0.4, 0.1)):
        ref = np.asarray(jassign.grid_assign_batch(
            jnp.asarray(anchors), jnp.asarray(responsible),
            jnp.asarray(boxes), jnp.asarray(valid), *args))
        got = grid_assign_batch(
            torch.from_numpy(anchors), torch.from_numpy(responsible),
            torch.from_numpy(boxes), torch.from_numpy(valid), *args).numpy()
        np.testing.assert_array_equal(got, ref)
        assert (got[0] >= 0).any() and (got[0] == -1).any()
        assert (got[2] == -1).all()  # no valid gt


@pytest.fixture(scope='module')
def v3_pair():
    cfg = v3_cfg(NUM_CLASSES)
    jmodel = jax_build_detector(cfg)
    img = np.random.RandomState(5).uniform(
        -0.5, 0.5, (2, IMG, IMG, 3)).astype(np.float32)
    variables = jax.tree.map(np.asarray, random_variables(jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0), jnp.asarray(img)), 6))
    det = init_detector(cfg, variables=variables, device='cpu',
                        dtype=torch.float32)
    ref = jax.jit(jmodel.apply)(variables, jnp.asarray(img))
    with torch.no_grad():
        got = det.model(torch.from_numpy(img))
    return jmodel, det, img, ref, got


def test_forward_matches_tpudet(v3_pair):
    _, det, _, ref, got = v3_pair
    assert type(det.model) is YOLOV3
    assert [tuple(g.shape) for g in got] == [
        (2, h, w, 3 * (5 + NUM_CLASSES)) for h, w in SIZES]
    for g, r in zip(got, ref):
        assert _max_rel(g.numpy(), np.asarray(r)) <= 1e-4


@pytest.mark.parametrize('reduction', ['sum', 'mean'])
def test_loss_and_its_gradient_match_tpudet(v3_pair, reduction):
    jmodel, det, _, ref, got = v3_pair
    head = det.model.bbox_head
    head.loss_reduction = reduction
    jhead = jmodel.bbox_head.clone(loss_reduction=reduction)
    boxes, labels, valid = _gts(7, b=2)
    for v in (valid, np.zeros_like(valid)):  # gts; none at all
        args = [jnp.asarray(a) for a in (boxes, labels, v)]

        def total(maps):
            losses = jhead.loss(maps, *args)
            return sum(x for k, x in losses.items() if 'loss' in k), losses

        (_, jl), jg = jax.jit(jax.value_and_grad(total, has_aux=True))(
            tuple(ref))
        maps = [torch.tensor(np.asarray(r), requires_grad=True) for r in ref]
        tl = head.loss(maps, *[torch.from_numpy(a) for a in (boxes, labels,
                                                              v)])
        assert set(tl) == set(jl)
        sum(x for k, x in tl.items() if 'loss' in k).backward()
        for k in jl:
            np.testing.assert_allclose(float(tl[k].detach()), float(jl[k]),
                                       rtol=1e-5,
                                       atol=1e-7, err_msg=k)
        for m, g in zip(maps, jg):
            np.testing.assert_allclose(m.grad.numpy(), np.asarray(g),
                                       rtol=1e-5,
                                       atol=1e-5 * np.abs(g).max())
        if v.any():
            assert float(tl['loss_xy'].detach()) > 0
            assert float(tl['num_gts']) == 3.5
            own = head.loss(got, *[torch.from_numpy(a)
                                   for a in (boxes, labels, v)])
            for k in jl:
                np.testing.assert_allclose(float(own[k]), float(jl[k]),
                                           rtol=1e-4, err_msg=k)
        else:  # the all-empty batch: only the objectness term
            assert float(tl['loss_conf'].detach()) > 0
            for k in ('loss_cls', 'loss_xy', 'loss_wh'):
                assert float(tl[k].detach()) == 0, k
    head.loss_reduction = 'sum'


def _to_torch(maps):
    return tuple(torch.tensor(np.asarray(m)) for m in maps)


@pytest.mark.parametrize('rescale', [True, False])
def test_get_bboxes_matches_tpudet(v3_pair, rescale):
    jmodel, det, img, ref, got = v3_pair
    kw, tkw = {}, {}
    if rescale:
        sf = np.array([[2., 2., 2., 2.], [1.5, 1.25, 1.5, 1.25]], np.float32)
        kw, tkw = dict(scale_factors=jnp.asarray(sf)), dict(
            scale_factors=torch.from_numpy(sf))
    rj = jax.jit(lambda maps, kw: jmodel.get_bboxes(maps, **kw))(ref, kw)
    same = det.model.get_bboxes(_to_torch(ref), **tkw)
    assert int(same.valid.sum(1).min()) > 0
    assert_detections_equal(same, rj)
    assert_one_to_one(det.model.get_bboxes(got, **tkw), rj, 1e-3)
    raw_j = jmodel.bbox_head.get_bboxes(ref, with_nms=False)
    raw_t = det.model.bbox_head.get_bboxes(_to_torch(ref), with_nms=False)
    for g, r in zip(raw_t, raw_j):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-4)


def test_a_train_step_matches_tpudet():
    """One step of tpudet's ``make_train_step`` against the port's, from
    tpudet's init with its BatchNorm scales at 0.25 (as
    ``test_torch_train_step.py``), 2 images of 96 px. At 64 px Darknet's
    stride-32 maps are 2 x 2, its BatchNorms see 8 values a channel, and
    fp32 rounding alone moves the gradient norm by 2e-3 (in float64 the
    two agree within 1e-7)."""
    opt = dict(lr=0.01, total_steps=50, warmup_iters=3, steps_per_epoch=0,
               grad_clip_norm=10.0)
    ema = dict(ema_momentum_base=0.9999, ema_warm_up=4, ema_interval=1)
    cfg = v3_cfg(NUM_CLASSES)
    jmodel = jax_build_detector(cfg)
    jopt = JaxSGDConfig(**opt)
    state0 = jax.device_get(jax_create_state(
        jmodel, jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)), jopt))
    scale = lambda tree: jax.tree_util.tree_map_with_path(  # noqa: E731
        lambda p, v: np.full_like(v, 0.25) if p[-1].key == 'scale' else v,
        tree)
    state0 = state0.replace(params=scale(state0.params),
                            ema_params=scale(state0.ema_params))
    batch = tiny_batch(seed=3, batch_size=2, size=IMG)
    jstate, jm = jax.jit(jax_make_train_step(jmodel, jopt, **ema))(state0,
                                                                   batch)
    model = build_detector(cfg)
    t_opt = YoloSGDConfig(**opt)
    state = train_state_from_flax(state0, model, t_opt)
    state, tm = make_train_step(model, t_opt, **ema)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ('loss', 'loss_cls', 'loss_conf', 'loss_xy', 'loss_wh',
              'num_gts', 'grad_norm', 'lr', 'momentum'):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   err_msg=k)
    assert math.isfinite(float(jm['loss'])) and float(jm['grad_norm']) > 0
    jstate, tstate = jax.device_get(jstate), train_state_to_flax(state,
                                                                 model)
    for what in ('params', 'batch_stats', 'ema_params', 'ema_batch_stats'):
        assert_tree_close(getattr(tstate, what), getattr(jstate, what),
                          getattr(state0, what), what)
    assert_tree_close(tstate.opt_state.momentum_buf,
                      jstate.opt_state.momentum_buf,
                      state0.opt_state.momentum_buf, 'momentum_buf')


CONFIG = 'configs/yolo/yolov3_d53_mstrain-608_273e_coco.py'


def test_train_detector_and_the_test_cli_take_a_yolov3_config(tmp_path):
    """``train_detector`` (2 steps on the plain loader, a checkpoint, the
    EMA evaluation) and the test CLI on its weights, equal to
    ``single_device_test`` + ``coco_fast_bbox_eval``, on the 608 config
    narrowed to tpudet's test widths, 3 classes and 64 px pipelines."""
    from tpudet_torch.apis import single_device_test, train_detector
    from tpudet_torch.data import build_dataset
    from tpudet_torch.evaluation import coco_fast_bbox_eval
    from tpudet_torch.tools import test as cli
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    _write_set(tmp_path, NO_RESIZE[:4], 19)
    norm = dict(mean=[0, 0, 0], std=[255., 255., 255.], to_rgb=True)
    train = [dict(type='LoadImageFromFile'),
             dict(type='LoadAnnotations', with_bbox=True),
             dict(type='Resize', img_scale=(64, 64), keep_ratio=True),
             dict(type='RandomFlip', flip_ratio=0.5),
             dict(type='Normalize', **norm), dict(type='Pad', size_divisor=32)]
    test = [dict(type='LoadImageFromFile'),
            dict(type='MultiScaleFlipAug', img_scale=(64, 64), flip=False,
                 transforms=[dict(type='Resize', keep_ratio=True),
                             dict(type='RandomFlip'),
                             dict(type='Pad', size_divisor=32),
                             dict(type='Normalize', **norm)])]
    sets = {k: dict(ann_file=str(tmp_path / 'ann.json'),
                    img_prefix=str(tmp_path), classes=CLASSES, pipeline=p)
            for k, p in (('train', train), ('val', test), ('test', test))}
    path = tmp_path / 'yolov3_tiny.py'
    path.write_text(f'''_base_ = {os.path.join(root, CONFIG)!r}
model = dict(neck=dict(out_channels=[128, 64, 32]),
             bbox_head=dict(num_classes=3, in_channels=[128, 64, 32],
                            out_channels=[256, 128, 64]))
data = dict(samples_per_gpu=2, train_img_size=64, max_gts=8,
            train={sets['train']!r},
            val=dict(test_mode=True, **{sets['val']!r}),
            test=dict(test_mode=True, **{sets['test']!r}))
runner = dict(max_epochs=1)
log_config = dict(interval=1)
''')
    cfg = Config.fromfile(str(path))
    work = str(tmp_path / 'work')
    metrics = train_detector(cfg, work, max_steps=2, device='cpu')
    assert {'loss', 'loss_cls', 'loss_conf', 'loss_xy', 'loss_wh',
            'grad_norm'} <= set(metrics)
    assert math.isfinite(metrics['loss'])
    weights = os.path.join(work, 'latest_ema.msgpack')
    report = cli.main([str(path), weights, '--img-size', '64', '--device',
                       'cpu'])
    det = init_detector(cfg, weights, device='cpu', dtype=torch.float32)
    assert type(det.model) is YOLOV3 and det.CLASSES == CLASSES
    ds = build_dataset({**cfg['data']['test'], 'test_mode': True},
                       dict(device='cpu'))
    ref = coco_fast_bbox_eval(
        single_device_test(det.model, ds, batch_size=8, img_size=64,
                           progress=False),
        [ds.get_ann_info_test(i) for i in range(len(ds))],
        classes=ds.CLASSES)
    assert list(report) == list(ref)
    np.testing.assert_allclose([report[k] for k in ref],
                               [ref[k] for k in ref], atol=1e-6)
