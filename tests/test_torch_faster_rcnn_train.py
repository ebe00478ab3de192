"""Training the two-stage family in the port against tpudet, on the CPU:
the detectors of ``test_torch_faster_rcnn.py`` (ResNet-18, an FPN of 64
channels, 3 classes, 128 px, batches of 2).

Tolerances:

- ``forward_train`` (BatchNorm in train mode), in float64 on both sides
  (jax's x64, the port's ``.double()``; the losses still cast the pred
  maps to fp32, as both packages do): each loss rtol 1e-4, each
  parameter's gradient rtol 1e-4 with atol 1e-4 of its largest |value|
  (measured: within 2.1e-7);
- 2 steps of tpudet's ``make_train_step`` (its ``forward_train`` loss
  path) against ``init_trainer(device='cpu')``, in float64 as above:
  losses and the gradient norm rtol 1e-4 at each step, the state within
  5e-3 of the largest change the steps made (``test_torch_train_step.py``'s
  yardstick);
- the entry points (``train_detector``, the test CLI, ``Detector``) on a
  narrowed ``faster_rcnn_r50_fpn_1x_coco.py``; the CLI's report equal to
  the API's within 1e-6; an image larger than the eval canvas;
- a tiny batch is learnt (the port of ``tests/test_runtime/
  test_overfit_two_stage.py``, at lr 0.01 for 50 steps: see the test):
  the loss halves and the EMA weights reach mAP@0.5 > 0.3.

Why float64 for training: in fp32 the two frameworks round the deep
network differently by ~1e-5, and that flips discrete decisions that
are well defined but not stable under rounding. A ReLU input within that
distance of 0 changes sides: one BatchNorm output of ResNet-18's
``layer4_1`` measured 9.8e-6 in float64, -1.9e-6 in the port's fp32,
moving one channel of the gradient by 53 % of its leaf's largest value.
Proposal scores 6e-8 apart swap slots, so the fixed-priority sampler
takes other rois. In float64 neither happens at these sizes.
"""
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet.apis.train import opt_config_from_cfg as jax_opt_config
from tpudet.models.builder import build_detector as jax_build_detector
from tpudet.train.optim import YoloSGDConfig as JaxSGDConfig
from tpudet.train.train_state import create_train_state as jax_create_state
from tpudet.train.train_state import make_train_step as jax_make_train_step
from tpudet_torch.apis import init_detector, init_trainer
from tpudet_torch.apis.train import forward_train_loss
from tpudet_torch.config import Config
from tpudet_torch.models.builder import build_detector
from tpudet_torch.models.detectors import FasterRCNN
from tpudet_torch.train.optim import YoloSGDConfig
from tpudet_torch.utils.flax_import import (leaf_table, load_flax_variables,
                                            train_state_to_flax)

from .test_torch_faster_rcnn import (IMG, NUM_CLASSES, _img, _jax_init_args,
                                     _proposals, _t, det_variables,
                                     frcnn_cfg)
from .test_torch_rpn_head import gts
from .test_torch_test_flow import CLASSES, NO_RESIZE, _write_set
from .test_torch_train_step import assert_tree_close


@pytest.fixture(scope='module', params=['FasterRCNN', 'FastRCNN'])
def train_pair(request):
    kind = request.param
    cfg = frcnn_cfg(kind)
    jmodel = jax_build_detector(cfg)
    variables = det_variables(jmodel, _jax_init_args(kind, _img(5)), 6)
    return kind, cfg, jmodel, variables


def _jax_losses(jmodel, variables, kind, batch):
    """tpudet's ``forward_train`` loss of ``kind`` and its gradient with
    respect to the params, BatchNorm in train mode, in float64."""
    names = ('img', 'gt_bboxes', 'gt_labels', 'gt_valid')
    if kind == 'FastRCNN':
        names = ('img', 'proposals', 'prop_valid') + names[1:]
    variables = f64(variables)

    def total(params, args):
        v = {'params': params, 'batch_stats': variables['batch_stats']}
        losses, _ = jmodel.apply(v, *args, method='forward_train',
                                 mutable=['batch_stats'])
        return sum(x for k, x in losses.items() if 'loss' in k), losses

    with jax.enable_x64(True):
        args = [jnp.asarray(batch[k]) for k in names]
        assert args[0].dtype == jnp.float64
        (_, losses), grads = jax.jit(jax.value_and_grad(
            total, has_aux=True))(variables['params'], args)
        return jax.device_get((losses, grads))


def f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


def _batch(kind, img_seed=7):
    """A batch: the image in float64, the gts (and proposals) in fp32."""
    boxes, labels, valid = gts(3)
    batch = dict(img=_img(img_seed).astype(np.float64), gt_bboxes=boxes,
                 gt_labels=labels, gt_valid=valid)
    if kind == 'FastRCNN':
        batch['proposals'], batch['prop_valid'] = _proposals(8)
    return batch


def test_forward_train_losses_and_gradients_match_tpudet(train_pair):
    kind, cfg, jmodel, variables = train_pair
    batch = _batch(kind)
    jl, jg = _jax_losses(jmodel, variables, kind, batch)
    model = build_detector(cfg)
    load_flax_variables(model, variables)
    model.double().train()
    model.dtype = torch.float64
    tl = forward_train_loss(model)({k: _t(v) for k, v in batch.items()})
    assert set(tl) == set(jl)
    sum(v for k, v in tl.items() if 'loss' in k).backward()
    for k in jl:
        np.testing.assert_allclose(float(tl[k].detach()), float(jl[k]),
                                   rtol=1e-4, err_msg=k)
    grads = {key: p.grad for key, p in model.named_parameters()}
    got = state_dict_to_flax_grads(model, grads)
    ref = jax.tree_util.tree_leaves_with_path(jg)
    assert len(got) == len(ref)
    for path, r in ref:
        name = '/'.join(k.key for k in path)
        r = np.asarray(r)
        np.testing.assert_allclose(got[name], r, rtol=1e-4,
                                   atol=1e-4 * np.abs(r).max(),
                                   err_msg=name)
    assert max(np.abs(np.asarray(r)).max() for _, r in ref) > 0


def state_dict_to_flax_grads(model, grads):
    """The gradients by flax path (``'backbone/stem_conv/kernel'``), in
    tpudet's layout."""
    from tpudet_torch.utils.flax_import import _tree
    tree = _tree(leaf_table(model), grads, 'params')
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                out['/'.join(prefix + (k,))] = v
    walk(tree, ())
    return out


def test_forward_train_takes_its_arguments_by_name():
    model = build_detector(frcnn_cfg('FastRCNN'))
    batch = {k: _t(v) for k, v in _batch('FastRCNN').items()}
    del batch['prop_valid']
    with pytest.raises(TypeError, match="requires parameter 'prop_valid'"):
        forward_train_loss(model)(batch)


# two train steps against tpudet's make_train_step

STEP_CFG = dict(
    optimizer=dict(type='SGD', lr=0.02, momentum=0.9, weight_decay=1e-4,
                   nesterov=False),
    optimizer_config=dict(grad_clip=dict(max_norm=35)),
    lr_config=dict(policy='step', step=[8, 11], gamma=0.1),
    # the warm-up at the full lr: a warm-up from 1e-3 of it would leave
    # an update near the params' fp32 step
    custom_hooks=[dict(type='DetailedLinearWarmUpHook', warmup_iters=500,
                       lr_weight_warmup_ratio=1.0, lr_bias_warmup_ratio=1.0,
                       momentum_warmup_ratio=1.0),
                  dict(type='StateEMAHook', momentum=0.9999, warm_up=4)],
    data=dict(samples_per_gpu=2), seed=0)
STEPS = 2


@pytest.fixture(scope='module')
def step_runs():
    """Both packages' steps from tpudet's init (``create_train_state``),
    in float64."""
    from tpudet_torch.train.train_state import create_train_state
    cfg = frcnn_cfg()
    jmodel = jax_build_detector(cfg)
    jopt = jax_opt_config(STEP_CFG, STEPS, 1)
    state0 = jax.device_get(jax_create_state(
        jmodel, jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)), jopt))
    state0 = jax.tree.map(lambda a: np.asarray(a, np.float64)
                          if a.dtype == np.float32 else a, state0)

    def loss_fn(params, batch_stats, b):
        losses, mutated = jmodel.apply(
            {'params': params, 'batch_stats': batch_stats}, b['img'],
            b['gt_bboxes'], b['gt_labels'], b['gt_valid'],
            method='forward_train', mutable=['batch_stats'])
        total = sum(v for k, v in losses.items() if 'loss' in k)
        return total, (losses, mutated['batch_stats'])

    jstep = jax.jit(jax_make_train_step(jmodel, jopt, ema_momentum_base=0.9999,
                                        ema_warm_up=4, loss_fn=loss_fn))
    trainer = init_trainer(Config(dict(STEP_CFG, model=cfg)),
                           variables={'params': state0.params,
                                      'batch_stats': state0.batch_stats},
                           device='cpu', max_steps=STEPS)
    trainer.model.double()
    trainer.model.dtype = torch.float64
    trainer.state = create_train_state(trainer.model, trainer.opt_cfg)
    init = train_state_to_flax(trainer.state, trainer.model)
    jstate, jm, tm = state0, [], []
    for step in range(STEPS):
        batch = _batch('FasterRCNN', img_seed=20 + step)
        with jax.enable_x64(True):
            jstate, m = jstep(jstate, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
            jm.append({k: float(v) for k, v in m.items()})
        tm.append({k: float(v) for k, v in trainer.step(batch).items()})
    return (init, state0, jax.device_get(jstate), jm,
            train_state_to_flax(trainer.state, trainer.model), tm)


def test_train_steps_losses_match_tpudet(step_runs):
    init, state0, _, jm, _, tm = step_runs
    assert_tree_close(init.params, state0.params, state0.params, 'init')
    for j, t in zip(jm, tm):
        for k in ('loss', 'loss_rpn_cls', 'loss_rpn_bbox', 'loss_cls',
                  'loss_bbox', 'num_gts', 'grad_norm', 'lr', 'momentum'):
            np.testing.assert_allclose(t[k], j[k], rtol=1e-4, err_msg=k)
        assert math.isfinite(j['loss']) and j['grad_norm'] > 0


@pytest.mark.parametrize('what', ['params', 'batch_stats', 'ema_params',
                                  'ema_batch_stats', 'momentum_buf'])
def test_train_steps_state_matches_tpudet(step_runs, what):
    _, state0, jstate, _, tstate, _ = step_runs
    if what == 'momentum_buf':
        got, ref, init = (tstate.opt_state.momentum_buf,
                          jstate.opt_state.momentum_buf,
                          state0.opt_state.momentum_buf)
    else:
        got, ref, init = (getattr(tstate, what), getattr(jstate, what),
                          getattr(state0, what))
    assert jax.tree.structure(got) == jax.tree.structure(ref)
    assert_tree_close(got, ref, init, what)


# the entry points on a Faster R-CNN config

CONFIG = 'configs/faster_rcnn/faster_rcnn_r50_fpn_1x_coco.py'


def tiny_config(d, root):
    """``faster_rcnn_r50_fpn_1x_coco.py`` narrowed (ResNet-18, 32
    channels, 3 classes, 128 px pipelines, fewer proposals) over JPEGs in
    ``d``."""
    norm = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375],
                to_rgb=True)
    train = [dict(type='LoadImageFromFile'),
             dict(type='LoadAnnotations', with_bbox=True),
             dict(type='Resize', img_scale=(128, 128), keep_ratio=True),
             dict(type='RandomFlip', flip_ratio=0.5),
             dict(type='Normalize', **norm), dict(type='Pad', size_divisor=64)]
    test = [dict(type='LoadImageFromFile'),
            dict(type='MultiScaleFlipAug', img_scale=(128, 128), flip=False,
                 transforms=[dict(type='Resize', keep_ratio=True),
                             dict(type='RandomFlip'),
                             dict(type='Pad', size_divisor=64),
                             dict(type='Normalize', **norm)])]
    sets = {k: dict(ann_file=str(d / 'ann.json'), img_prefix=str(d),
                    classes=CLASSES, pipeline=p)
            for k, p in (('train', train), ('val', test), ('test', test))}
    path = d / 'frcnn_tiny.py'
    path.write_text(f'''_base_ = {os.path.join(root, CONFIG)!r}
model = dict(backbone=dict(depth=18),
             neck=dict(in_channels=[64, 128, 256, 512], out_channels=32),
             rpn_head=dict(in_channels=32, feat_channels=32),
             roi_head=dict(num_classes=3, in_channels=32, num_samples=128),
             train_cfg=dict(rpn_proposal=dict(nms_pre=500, max_per_img=200)),
             test_cfg=dict(rpn=dict(nms_pre=500, max_per_img=200)))
data = dict(samples_per_gpu=2, train_img_size=128, max_gts=8,
            train={sets['train']!r},
            val=dict(test_mode=True, **{sets['val']!r}),
            test=dict(test_mode=True, **{sets['test']!r}))
runner = dict(max_epochs=1)
log_config = dict(interval=1)
''')
    return str(path)


def test_train_detector_and_the_test_cli_take_a_faster_rcnn_config(
        tmp_path):
    """``train_detector`` (the ``forward_train`` loss path, 2 steps, a
    checkpoint, the EMA evaluation) and the test CLI on its weights, equal
    to ``single_device_test`` + ``coco_fast_bbox_eval``."""
    from tpudet_torch.apis import single_device_test, train_detector
    from tpudet_torch.data import build_dataset
    from tpudet_torch.evaluation import coco_fast_bbox_eval
    from tpudet_torch.tools import test as cli
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    _write_set(tmp_path, NO_RESIZE[:4], 17)
    cfg_path = tiny_config(tmp_path, root)
    cfg = Config.fromfile(cfg_path)
    work = str(tmp_path / 'work')
    metrics = train_detector(cfg, work, max_steps=2, device='cpu')
    assert {'loss', 'loss_rpn_cls', 'loss_rpn_bbox', 'loss_cls',
            'loss_bbox', 'num_gts', 'grad_norm'} <= set(metrics)
    assert math.isfinite(metrics['loss'])
    assert sorted(os.listdir(os.path.join(work, 'ckpts'))) == ['2']
    weights = os.path.join(work, 'latest_ema.msgpack')
    report = cli.main([cfg_path, weights, '--img-size', '128', '--device',
                       'cpu'])
    det = init_detector(cfg, weights, device='cpu', dtype=torch.float32)
    assert type(det.model) is FasterRCNN and det.CLASSES == CLASSES
    ds = build_dataset({**cfg['data']['test'], 'test_mode': True},
                       dict(device='cpu'))
    ref = coco_fast_bbox_eval(
        single_device_test(det.model, ds, batch_size=8, img_size=128,
                           progress=False),
        [ds.get_ann_info_test(i) for i in range(len(ds))],
        classes=ds.CLASSES)
    assert list(report) == list(ref)
    np.testing.assert_allclose([report[k] for k in ref],
                               [ref[k] for k in ref], atol=1e-6)


def test_an_image_larger_than_the_canvas_widens_it(tmp_path):
    """``single_device_test`` at an ``img_size`` under the test scale (the
    two-stage configs test at 1333 x 800, the default canvas is 640):
    tpudet's loader raises; the port's widens the canvas, and the
    detections equal those on a canvas that holds the images."""
    from tpudet_torch.apis import single_device_test
    from tpudet_torch.data import build_dataset
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    _write_set(tmp_path, NO_RESIZE[:3], 18)
    cfg = Config.fromfile(tiny_config(tmp_path, root))
    det = init_detector(cfg, device='cpu', dtype=torch.float32)
    ds = build_dataset({**cfg['data']['test'], 'test_mode': True},
                       dict(device='cpu'))
    small, full = (single_device_test(det.model, ds, batch_size=3,
                                      img_size=size, progress=False)
                   for size in (64, 128))
    for a, b in zip(small, full):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert sum(len(x) for r in full for x in r) > 0


def test_faster_rcnn_learns_a_tiny_batch():
    """tpudet's two-stage learning check on the port, from tpudet's init
    (``PRNGKey(0)``) on tpudet's batch of 4 (coloured rectangles, 64 px):
    the loss halves and the EMA weights then find the boxes (mAP@0.5 >
    0.3).

    At tpudet's lr 0.02 the run is chaotic at this size: moving the
    images by 1e-3 makes tpudet's own run reach a loss of 103 within 60
    steps, and the port's unperturbed run reaches 148 (a single step from
    any of tpudet's states along its run equals tpudet's to 1e-5). At lr
    0.01 the port's runs with the images moved by 0, 1e-5 and 1e-3 all end
    300 steps at 2.4-3.1 % of their first loss; 50 steps reach 15 % and
    mAP@0.5 1.0, so 50 steps at lr 0.01 here."""
    from tpudet_torch.evaluation.mean_ap import eval_map_flexible
    from tpudet_torch.apis.inference import nms_result_to_per_class
    from tpudet_torch.train.train_state import (create_train_state,
                                                 make_train_step)
    from .test_runtime.test_overfit import make_batch
    torch.manual_seed(0)
    cfg = dict(frcnn_cfg(num_samples=64),
               train_cfg=dict(rpn_proposal=dict(nms_pre=256,
                                                max_per_img=64)),
               test_cfg=dict(rpn=dict(nms_pre=256, max_per_img=64),
                             rcnn=dict(score_thr=0.1,
                                       nms=dict(iou_threshold=0.5),
                                       max_per_img=10)))
    opt_kw = dict(lr=0.01, momentum=0.9, total_steps=50, warmup_iters=20,
                  min_lr_ratio=0.2, weight_decay=0.0)
    jstate = jax_create_state(jax_build_detector(cfg), jax.random.PRNGKey(0),
                              jnp.zeros((1, 64, 64, 3)),
                              JaxSGDConfig(**opt_kw))
    model = build_detector(cfg)
    load_flax_variables(model, jax.device_get(
        {'params': jstate.params, 'batch_stats': jstate.batch_stats}))
    batch = make_batch(size=64)
    opt = YoloSGDConfig(**opt_kw)
    state = create_train_state(model, opt)
    step = make_train_step(model, opt, loss_fn=forward_train_loss(model))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    first = None
    for _ in range(50):
        state, metrics = step(state, tb)
        first = first if first is not None else float(metrics['loss'])
    final = float(metrics['loss'])
    assert final < first * 0.5, (first, final)

    from tpudet_torch.apis.train import ema_swapped_in
    model.eval()
    with ema_swapped_in(state), torch.no_grad():
        res = model.get_bboxes(model(tb['img']))
    results = nms_result_to_per_class(res, NUM_CLASSES)
    annotations = []
    for i in range(4):
        n = int(batch['gt_valid'][i].sum())
        boxes = batch['gt_bboxes'][i][:n]
        area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
        annotations.append(dict(
            gt_bboxes=boxes,
            gt_labels=batch['gt_labels'][i][:n].astype(np.int64),
            gt_attrs=dict(ignore=np.zeros(n, bool),
                          iscrowd=np.zeros(n, bool),
                          area=area.astype(np.float32))))
    report = eval_map_flexible(results, annotations, iou_thrs=[0.5],
                               classes=('a', 'b', 'c'))
    assert report['map'] > 0.3, report
