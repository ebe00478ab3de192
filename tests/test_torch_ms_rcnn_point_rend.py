"""Mask Scoring R-CNN and PointRend (ROADMAP.md's zoo row i) in
tpudet_torch against tpudet, on the CPU, from numpy seeds: the detectors
of ``test_torch_htc_scnet.py`` (ResNet-18 of 16 base channels, an FPN of
32, 3 classes).

Tolerances:

- Mask Scoring R-CNN's IoU branch (``mask_iou_forward`` on given
  features and mask logits, ``mask_iou_loss``), fp32, the IoU head's
  ReLU inputs kept positive (``linear_heads``): the loss rtol 1e-5, every
  gradient (the IoU head's parameters, the features, the mask logits)
  within 1e-4 of its largest |value|;
- ``point_sample_map``: within 1e-6 of the largest |value| at points
  inside, on and outside the map's edges;
- the hash (``hash_uniform``) on real keys: float64 within 1e-10; in fp32
  the two libraries' ``sin`` part by an ulp on 1-2 % of the draws
  (arguments of 1e3-1e5), 2^-8 in a coordinate after the x 43758.5453:
  measured here, at most 3 % of the draws, none further than 2^-8;
- PointRend's training branch in fp32 on given features and coarse
  logits, on tpudet's points (fed in): ``point_train``'s logits, the
  coarse loss and ``point_loss`` rtol 1e-5, the gradients of the coarse
  and point heads and of the features within 1e-4 of their largest
  |value| (``linear_heads``); of tpudet's points of the same slots, at
  least 97 % are within 2^-8 of one of the port's own, 90 % within 1e-6
  (a draw that moves can change which candidates are the most
  uncertain);
- ``refine_masks`` (eval, fp32, 5 rounds to 224 x 224 as the config):
  the probabilities within 1e-5 at all but 0.5 % of the pixels (a tie of
  ``-|logit|`` at the 784th point, which the 2x upsample makes common,
  falls on either side under one ulp of rounding; the stable order of
  both packages keeps the lower index);
- the detectors (fp32, eval mode, 96 px): the forward outputs within
  1e-4 of their largest |value|; PointRend's ``predict_masks`` on
  tpudet's detections: (B, D, 224, 224) probabilities within 1e-4 at all
  but 0.5 % of the pixels;
- ``forward_train`` in float64 on both sides (BatchNorm in train mode,
  16 rois sampled an image):
  every loss rtol 1e-4 (Mask Scoring R-CNN's ``loss_mask_iou``,
  PointRend's ``loss_point``, the hash in both swapped for one that moves
  little with its key: the port's rois are fp32 in a float64 run); one
  ``init_trainer(...).step`` of each: finite, the params moved;
- ``single_device_test(with_masks=True)`` in the ``'roi_labels'`` mode on
  the committed shapes fixtures: tpudet's detections and RLE masks
  (``test_torch_mask_eval.py``'s one-to-one rule).
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet.models.roi_heads.point_rend_roi_head import \
    _hash_uniform as jax_hash_uniform
from tpudet.models.roi_heads.point_rend_roi_head import \
    point_sample_map as jax_point_sample_map
from tpudet_torch.apis.test import _mask_mode
from tpudet_torch.models.roi_heads.point_rend_roi_head import (
    KEY_WEIGHTS, hash_uniform, point_sample_map)

from .test_torch_htc_scnet import (NUM_CLASSES, _assert_grads,
                                   _branch_inputs, _flat_grads, _head_grads,
                                   _load_roi_head, _torch_inputs,
                                   assert_close, assert_losses_match,
                                   assert_trainer_steps, f64_cfg,
                                   float64_losses, forward_pair, images,
                                   linear_heads, mask_batch, rcnn_cfg)
from . import torch_fixtures  # noqa: F401  (one intra-op thread)

KINDS = ('ms_rcnn', 'point_rend')


def zoo_cfg(kind):
    if kind == 'ms_rcnn':
        return rcnn_cfg('MaskScoringRCNN', dict(type='MaskScoringRoIHead'))
    return rcnn_cfg('PointRend', dict(type='PointRendRoIHead',
                                      max_num_point_rois=8))


def _build(kind):
    """(kind, cfg, tpudet's model, variables, the port's model)."""
    return (kind, zoo_cfg(kind)) + forward_pair(zoo_cfg(kind), 5)


@pytest.fixture(scope='module')
def ms_pair():
    return _build('ms_rcnn')


@pytest.fixture(scope='module')
def pr_pair():
    return _build('point_rend')


@pytest.fixture(scope='module', params=KINDS)
def pair(request):
    return request.getfixturevalue(
        {'ms_rcnn': 'ms_pair', 'point_rend': 'pr_pair'}[request.param])


# Mask Scoring R-CNN's IoU branch

def test_mask_iou_branch_and_its_gradients_match_tpudet(ms_pair):
    _, _, jmodel, variables, model = ms_pair
    x = _branch_inputs(11)
    logits = np.random.RandomState(12).randn(2, 12, 28, 28,
                                             NUM_CLASSES).astype(np.float32)
    jhead = jmodel.roi_head
    params = linear_heads(variables['params'])['roi_head']
    names = ('mask_iou_head',)

    def jtotal(p, feats, lg):
        v = {'params': {**params, **p}}
        ious = jhead.apply(v, tuple(feats), x['rois'], x['valid'], lg,
                           x['labels'], method='mask_iou_forward')
        return jhead.apply(v, ious, lg, x['rois'], x['pos'], x['gt_idx'],
                           x['gt_boxes'], x['gt_frame_masks'], x['labels'],
                           method='mask_iou_loss')['loss_mask_iou']
    ref, (jg, jf, jl) = jax.jit(jax.value_and_grad(jtotal,
                                                   argnums=(0, 1, 2)))(
        {n: params[n] for n in names}, [jnp.asarray(f) for f in x['feats']],
        jnp.asarray(logits))
    head = _load_roi_head(model, params)
    t = _torch_inputs(x)
    tl = torch.tensor(logits, requires_grad=True)
    ious = head.mask_iou_forward(t['feats'], t['rois'], t['valid'], tl,
                                 t['labels'])
    total = head.mask_iou_loss(ious, tl, t['rois'], t['pos'], t['gt_idx'],
                               t['gt_boxes'], t['gt_frame_masks'],
                               t['labels'])['loss_mask_iou']
    total.backward()
    assert float(ref) > 0
    np.testing.assert_allclose(float(total), float(ref), rtol=1e-5)
    _assert_grads(_flat_grads(jg, names), _head_grads(head, names))
    _assert_grads({'logits': jl, **{f'f{i}': g for i, g in enumerate(jf)}},
                  {'logits': tl.grad.numpy(),
                   **{f'f{i}': f.grad.permute(0, 2, 3, 1).numpy()
                      for i, f in enumerate(t['feats'])}})


def test_mask_scoring_rescores_nothing_at_test_time(ms_pair):
    """tpudet's ``MaskScoringRCNN`` keeps Mask R-CNN's test path (its
    module docstring speaks of test-time rescoring; its code has none):
    so does the port's, and the IoU head does not run in the test
    flow."""
    from tpudet.models.roi_heads.mask_head import MaskRCNN as JaxMaskRCNN
    from tpudet.models.roi_heads.mask_scoring_roi_head import \
        MaskScoringRCNN as JaxMaskScoringRCNN
    from tpudet_torch.apis.test import predict_masks
    from tpudet_torch.models.roi_heads import MaskRCNN, MaskScoringRCNN
    for ms, plain in ((JaxMaskScoringRCNN, JaxMaskRCNN),
                      (MaskScoringRCNN, MaskRCNN)):
        assert ms.predict_masks is plain.predict_masks
        assert ms.get_bboxes is plain.get_bboxes
    model = ms_pair[-1]
    calls = []
    hook = model.roi_head.mask_iou_head.register_forward_hook(
        lambda *args: calls.append(1))
    with torch.no_grad():
        res, probs = predict_masks(model, torch.from_numpy(images(5)),
                                   torch.ones(2, 4))
    hook.remove()
    assert not calls and int(res.valid.sum()) and probs.shape[2:] == (28, 28)


# PointRend's samplers and hash

def test_point_sample_map_matches_tpudet():
    rng = np.random.RandomState(3)
    feat = rng.randn(7, 9, 5).astype(np.float32)
    xy = np.concatenate([rng.uniform(-0.2, 1.2, (300, 2)),
                         [[0, 0], [1, 1], [0.5 / 9, 0.5 / 7], [1, 0]]]
                        ).astype(np.float32)
    ref = np.asarray(jax_point_sample_map(jnp.asarray(feat), jnp.asarray(xy)))
    got = point_sample_map(torch.from_numpy(feat)[None],
                           torch.from_numpy(xy)[None])[0].numpy()
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


def _real_keys(dtype, size=1344, seed=0):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, size * 0.7, (2, 96, 2))
    wh = rng.uniform(4, size * 0.3, (2, 96, 2))
    rois = np.concatenate([xy, xy + wh], -1).astype(dtype)
    t = torch.from_numpy(rois)
    key = torch.zeros_like(t[..., 0])
    for j, w in enumerate(KEY_WEIGHTS):
        key = key + t[..., j] * w
    key = key + torch.arange(2, dtype=torch.float32)[:, None] * 17.0
    with jax.enable_x64(dtype == np.float64):
        jkey = jax.vmap(lambda r, i: jnp.sum(r * jnp.asarray(KEY_WEIGHTS), -1)
                        + i * 17.0)(jnp.asarray(rois),
                                    jnp.arange(2, dtype=jnp.float32))
        jkey = np.asarray(jkey)
    return jkey, key


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_the_hash_on_real_keys(dtype):
    """The keys are equal; float64 draws agree, fp32 ones part where the
    two ``sin``s round apart (see the module docstring)."""
    jkey, key = _real_keys(dtype)
    np.testing.assert_array_equal(key.numpy(), jkey)
    with jax.enable_x64(dtype == np.float64):
        ref = np.asarray(jax.vmap(lambda k: jax_hash_uniform(
            k, 588, 78.233))(jnp.asarray(jkey)))
    got = hash_uniform(key, 588, 78.233).numpy()
    d = np.abs(got - ref)
    d = np.minimum(d, 1 - d)  # a draw that wraps past 1
    if dtype == np.float64:
        assert d.max() <= 1e-10
    else:
        assert d.max() <= 2 ** -8 and (d > 1e-6).mean() <= 0.03


# PointRend's training branch and refinement

def _point_inputs(seed, x):
    rng = np.random.RandomState(seed)
    coarse = rng.randn(2, 12, 7, 7, NUM_CLASSES).astype(np.float32)
    deltas = (rng.randn(2, 12, 4) * 0.2).astype(np.float32)
    return coarse, deltas


def test_point_rend_training_branch_matches_tpudet(pr_pair):
    """The coarse head's loss, ``point_train`` on tpudet's points and
    ``point_loss``, with their gradients."""
    _, _, jmodel, variables, model = pr_pair
    x = _branch_inputs(13)
    _, deltas = _point_inputs(14, x)
    jhead = jmodel.roi_head
    params = linear_heads(variables['params'])['roi_head']
    names = ('mask_head', 'point_head')
    order = np.argsort(~x['pos'], axis=1, kind='stable')[:, :8]
    gt_idx_k = np.take_along_axis(x['gt_idx'], order, 1)

    def jtotal(p, feats):
        v = {'params': {**params, **p}}
        coarse = jhead.apply(v, tuple(feats), x['rois'], x['valid'],
                             method='mask_forward')
        loss = jhead.apply(v, coarse, x['rois'], x['pos'], x['gt_idx'],
                           x['gt_boxes'], x['gt_frame_masks'], x['labels'],
                           method='mask_loss')['loss_mask']
        out = jhead.apply(v, tuple(feats), x['rois'], x['pos'], x['labels'],
                          deltas, coarse, method='point_train')
        pl = jhead.apply(v, *out, gt_idx_k, x['gt_frame_masks'],
                         method='point_loss')['loss_point']
        return loss + pl, (loss, pl, out[0], out[1])
    # eager, as tpudet's own tests run it: under jit XLA fuses the hash's
    # sin into another approximation, and half of tpudet's points move
    (ref, (jloss, jpl, jlogits, jpts)), (jg, jf) = jax.value_and_grad(
        jtotal, argnums=(0, 1), has_aux=True)(
        {n: params[n] for n in names}, [jnp.asarray(f) for f in x['feats']])
    head = _load_roi_head(model, params)
    t = _torch_inputs(x)
    td = torch.from_numpy(deltas)
    coarse = head.mask_forward(t['feats'], t['rois'], t['valid'])
    loss = head.mask_loss(coarse, t['rois'], t['pos'], t['gt_idx'],
                          t['gt_boxes'], t['gt_frame_masks'],
                          t['labels'])['loss_mask']
    out = head.point_train(t['feats'], t['rois'], t['pos'], t['labels'], td,
                           coarse, points=torch.from_numpy(np.asarray(jpts)))
    pl = head.point_loss(*out, torch.from_numpy(gt_idx_k),
                         t['gt_frame_masks'])['loss_point']
    (loss + pl).backward()
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(pl), float(jpl), rtol=1e-5)
    lg = np.asarray(jlogits)
    assert np.abs(out[0].detach().numpy() - lg).max() <= \
        1e-5 * np.abs(lg).max()
    _assert_grads(_flat_grads(jg, names), _head_grads(head, names))
    # only P2 feeds the branch: tpudet's zero gradients of P3-P5, the
    # port's none
    _assert_grads({f'f{i}': g for i, g in enumerate(jf)},
                  {f'f{i}': np.zeros(g.shape, np.float32) if f.grad is None
                   else f.grad.permute(0, 2, 3, 1).numpy()
                   for i, (f, g) in enumerate(zip(t['feats'], jf))})
    # the port's own points: the same hash, the same top-k rule
    own = head.train_points(out[2], out[4], torch.gather(
        coarse, 1, torch.from_numpy(order)[..., None, None, None].expand(
            2, 8, 7, 7, NUM_CLASSES)))
    own, jpts = own.detach().numpy(), np.asarray(jpts)
    near = np.abs(own[:, :, :, None] - jpts[:, :, None]).max(-1) <= \
        2 ** -8 + 1e-6  # (B, K, port's point, tpudet's point)
    exact = np.abs(own[:, :, :, None] - jpts[:, :, None]).max(-1) <= 1e-6
    assert near.any(2).mean() >= 0.97 and exact.any(2).mean() >= 0.9


def test_refine_masks_matches_tpudet(pr_pair):
    _, _, jmodel, variables, model = pr_pair
    x = _branch_inputs(15, p=10)
    coarse, _ = _point_inputs(16, x)
    coarse = coarse[:, :10]
    labels = x['labels'][:, :10]
    ref = np.asarray(jax.jit(partial(jmodel.roi_head.apply,
                                     method='refine_masks'))(
        {'params': variables['params']['roi_head']},
        tuple(jnp.asarray(f) for f in x['feats']), x['rois'], x['valid'],
        labels, jnp.asarray(coarse)))
    t = _torch_inputs(x)
    with torch.no_grad():
        got = model.roi_head.refine_masks(
            [f.detach() for f in t['feats']], t['rois'], t['valid'],
            torch.from_numpy(labels), torch.from_numpy(coarse)).numpy()
    assert got.shape == ref.shape == (2, 10, 224, 224)
    assert (np.abs(got - ref) > 1e-5).mean() <= 0.005


# the detectors

def test_forward_and_masks_match_tpudet(pair):
    kind, _, jmodel, variables, model = pair
    img = images(5)
    ref = jax.jit(jmodel.apply)(variables, jnp.asarray(img))
    with torch.no_grad():
        got = model(torch.from_numpy(img))
    assert_close(got, ref)
    if kind != 'point_rend':
        assert _mask_mode(model) == 'roi'
        return
    res = jax.jit(jmodel.get_bboxes)(ref)
    assert int(np.asarray(res.valid).sum()) >= 10
    masks = np.asarray(jax.jit(partial(jmodel.apply,
                                       method='predict_masks'))(
        variables, jnp.asarray(img), res.bboxes, res.valid, res.labels))
    with torch.no_grad():
        got = model.predict_masks(*(torch.from_numpy(np.array(a)) for a in (
            img, res.bboxes, res.valid, res.labels))).numpy()
    assert _mask_mode(model) == 'roi_labels'
    assert got.shape == masks.shape == (2, 20, 224, 224)
    assert (np.abs(got - masks) > 1e-4).mean() <= 0.005


LOSS_KEYS = {'ms_rcnn': ['loss_mask', 'loss_mask_iou'],
             'point_rend': ['loss_mask', 'loss_point']}


def _smooth_hash(key_vals, n, salt, xp=torch):
    """A hash that moves little with its key: the port's rois are fp32
    in a float64 run (``StandardRoIHead.sample_rois``), tpudet's float64,
    and ``hash_uniform`` turns their ~1e-4 px apart into other points."""
    i = xp.arange(1, n + 1, dtype=xp.float32)
    return 0.5 + 0.5 * xp.sin(key_vals[..., None] * 1e-3 + i * salt * 1e-2)


def test_forward_train_losses_match_tpudet_in_float64(pair, monkeypatch):
    """PointRend's hash is swapped for ``_smooth_hash`` in both packages
    (the hash itself: ``test_the_hash_on_real_keys``)."""
    from tpudet.models.roi_heads import point_rend_roi_head as jpr
    from tpudet_torch.models.roi_heads import point_rend_roi_head as tpr
    monkeypatch.setattr(jpr, '_hash_uniform',
                        lambda k, n, salt: _smooth_hash(k, n, salt, jnp))
    monkeypatch.setattr(tpr, 'hash_uniform', _smooth_hash)
    kind, cfg, _, variables, _ = pair
    batch = mask_batch(23)
    jl, tl = float64_losses(f64_cfg(cfg), variables, batch)
    assert_losses_match(jl, tl, LOSS_KEYS[kind])
    assert all(tl[k] > 0 for k in LOSS_KEYS[kind])
    assert_trainer_steps(cfg, batch, variables)


# the test flow's 'roi_labels' mode on the committed fixtures

SHAPES = 'tests/torch_fixtures/shapes'
SHAPES_CLASSES = ('rect', 'circle', 'triangle')
FLOW_IMAGES = 4


def shapes_flow(tmp_path, cfg, variables, img=96):
    """tpudet's and the port's ``single_device_test(with_masks=True)`` of
    the first FLOW_IMAGES images of the committed shapes val set (a json
    of them in ``tmp_path``, the images where they are), both on
    ``variables``: ``(port's results, tpudet's)``."""
    import json
    import os

    from tpudet.apis.test import single_device_test as j_single_device_test
    from tpudet.data import CocoDataset as JCocoDataset
    from tpudet.models.builder import build_detector as j_build_detector
    from tpudet_torch.apis import init_detector, single_device_test
    from tpudet_torch.config import Config
    from tpudet_torch.data import CocoDataset

    from .test_torch_mask_eval import NORM
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, SHAPES, 'val.json')) as f:
        coco = json.load(f)
    ids = {im['id'] for im in coco['images'][:FLOW_IMAGES]}
    coco = dict(coco, images=coco['images'][:FLOW_IMAGES],
                annotations=[a for a in coco['annotations']
                             if a['image_id'] in ids])
    (tmp_path / 'val.json').write_text(json.dumps(coco))
    pipeline = [
        dict(type='LoadImageFromFile'),
        dict(type='MultiScaleFlipAug', img_scale=(img, img), flip=False,
             transforms=[dict(type='Resize', keep_ratio=True),
                         dict(type='RandomFlip'),
                         dict(type='Pad', size_divisor=32),
                         dict(type='Normalize', **NORM)])]
    args = dict(ann_file=str(tmp_path / 'val.json'), pipeline=pipeline,
                img_prefix=os.path.join(root, SHAPES, 'val/images'),
                classes=SHAPES_CLASSES, test_mode=True)
    ref = j_single_device_test(j_build_detector(cfg), variables,
                               JCocoDataset(**args), batch_size=2,
                               img_size=img, progress=False, with_masks=True)
    det = init_detector(Config(dict(model=cfg)), variables=variables,
                        device='cpu', dtype=torch.float32,
                        classes=SHAPES_CLASSES)
    got = single_device_test(det.model, CocoDataset(**args, device='cpu'),
                             batch_size=2, img_size=img, progress=False,
                             with_masks=True)
    return got, ref


def test_single_device_test_roi_labels_mode_matches_tpudet(pr_pair,
                                                           tmp_path):
    _, cfg, _, variables, _ = pr_pair
    from .test_torch_mask_eval import _assert_masks_one_to_one
    got, ref = shapes_flow(tmp_path, cfg, variables)
    assert _assert_masks_one_to_one(got, ref) >= 10
