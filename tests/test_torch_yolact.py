"""YOLACT (ROADMAP.md's zoo row i) and YOLACT's fast NMS in tpudet_torch
against tpudet, on the CPU, from numpy seeds: ResNet-18 (stages 2-4), an
FPN of 32 with 5 levels, a head of 32 with 8 prototypes, 3 classes, 128
px.

Tolerances:

- ``fast_nms`` / ``batched_fast_nms``: the valid slots equal (boxes,
  scores, labels, each detection's row; an invalid slot's row is not
  meaningful), on scores with many exact ties (a 1/64 grid) and repeated
  boxes, with and without a binding ``max_per_img``, and per image the
  batched form equal to the single one;
- the detector (BatchNorm in eval mode, fp32): the pred maps, the
  prototypes and the semantic logits within 1e-4 of each one's largest
  |value|; ``get_bboxes`` and ``predict_masks`` of tpudet's own outputs
  (rescaled and not): the valid slots equal, boxes within 1e-4 px, scores
  1e-6, coefficients and masks 1e-5;
- ``forward_train`` in float64 on both sides: every loss (the OHEM class
  loss, the box loss, the prototype mask loss, the semantic loss) rtol
  1e-4; one train step of tpudet's ``make_train_step`` against the
  port's, in float64: the losses and the gradient norm rtol 1e-4, the
  state within 5e-3 of the change the step made;
- ``single_device_test(with_masks=True)`` in the ``'proto'`` mode on the
  committed shapes fixtures: tpudet's detections and RLE masks
  (``test_torch_mask_eval.py``'s one-to-one rule).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet.core.nms import fast_nms as jax_fast_nms
from tpudet.models.builder import build_detector as jax_build_detector
from tpudet_torch.apis.test import _mask_mode
from tpudet_torch.core.nms import batched_fast_nms, fast_nms
from tpudet_torch.models.builder import build_detector
from tpudet_torch.utils.flax_import import load_flax_variables

from .test_torch_backbone_neck import random_variables
from .test_torch_htc_scnet import (assert_close, assert_losses_match,
                                   assert_trainer_steps, float64_losses,
                                   forward_train_args, frame_masks, gt_boxes)
from . import torch_fixtures  # noqa: F401  (one intra-op thread)

IMG, NUM_CLASSES, CH = 128, 3, 32


# fast NMS

def _nms_inputs(seed, n=300, c=5):
    """Boxes with repeats and scores on a 1/64 grid (exact ties)."""
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 200, (n, 2))
    wh = rng.uniform(5, 80, (n, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    boxes[1::7] = boxes[::7][:len(boxes[1::7])]
    scores = (np.round(rng.rand(n, c) * 64) / 64).astype(np.float32)
    return boxes, scores


def _assert_nms_equal(got, ref, got_idx=None, ref_idx=None):
    valid = np.asarray(ref.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.bboxes.numpy(), np.asarray(ref.bboxes))
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(ref.scores))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(ref.labels))
    if got_idx is not None:
        np.testing.assert_array_equal(got_idx.numpy()[valid],
                                      np.asarray(ref_idx)[valid])


@pytest.mark.parametrize('top_k,max_per_img', [(200, 100), (50, 200),
                                               (300, 20)])
def test_fast_nms_matches_tpudet_with_ties(top_k, max_per_img):
    boxes, scores = _nms_inputs(top_k)
    ref, ref_idx = jax_fast_nms(jnp.asarray(boxes), jnp.asarray(scores), 0.2,
                                0.5, top_k=top_k, max_per_img=max_per_img,
                                return_indices=True)
    got, got_idx = fast_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                            0.2, 0.5, top_k=top_k, max_per_img=max_per_img,
                            return_indices=True)
    assert int(np.asarray(ref.valid).sum()) >= 10
    _assert_nms_equal(got, ref, got_idx, ref_idx)
    plain = fast_nms(torch.from_numpy(boxes), torch.from_numpy(scores), 0.2,
                     0.5, top_k=top_k, max_per_img=max_per_img)
    _assert_nms_equal(plain, ref)


def test_batched_fast_nms_is_the_single_one_per_image():
    inputs = [_nms_inputs(s) for s in (1, 2, 3)]
    boxes = torch.from_numpy(np.stack([b for b, _ in inputs]))
    scores = torch.from_numpy(np.stack([s for _, s in inputs]))
    res, idx = batched_fast_nms(boxes, scores, 0.1, 0.6,
                                return_indices=True)
    for i in range(3):
        one, one_idx = fast_nms(boxes[i], scores[i], 0.1, 0.6,
                                return_indices=True)
        for a, b in zip(res, one):
            assert torch.equal(a[i], b)
        assert torch.equal(idx[i][one.valid], one_idx[one.valid])


# the detector

def yolact_cfg():
    return dict(
        type='YOLACT',
        backbone=dict(type='ResNet', depth=18, out_indices=[1, 2, 3]),
        neck=dict(type='FPN', in_channels=[128, 256, 512], out_channels=CH,
                  start_level=0, num_outs=5, add_extra_convs='on_input'),
        bbox_head=dict(type='YOLACTHead', num_classes=NUM_CLASSES,
                       in_channels=CH, feat_channels=CH, num_protos=8),
        test_cfg=dict(score_thr=0.05, nms=dict(type='nms', iou_threshold=0.5),
                      max_per_img=20, nms_pre=200, min_bbox_size=0))


def _img(seed, b=2, size=IMG):
    return np.random.RandomState(seed).uniform(
        -1.5, 1.5, (b, size, size, 3)).astype(np.float32)


def batch(seed, size=IMG):
    boxes, labels, valid = gt_boxes(seed, size=size)
    return dict(img=_img(seed, size=size).astype(np.float64),
                gt_bboxes=boxes, gt_labels=labels, gt_valid=valid,
                gt_frame_masks=frame_masks(seed + 1))


@pytest.fixture(scope='module')
def pair():
    cfg = yolact_cfg()
    jmodel = jax_build_detector(cfg)
    variables = jax.tree.map(np.asarray, random_variables(jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3))),
        6))
    model = build_detector(cfg)
    load_flax_variables(model, variables)
    return cfg, jmodel, variables, model.eval()


def test_forward_matches_tpudet(pair):
    _, jmodel, variables, model = pair
    img = _img(5)
    ref = jax.jit(jmodel.apply)(variables, jnp.asarray(img))
    with torch.no_grad():
        got = model(torch.from_numpy(img))
    assert_close(jax.tree.leaves(got), jax.tree.leaves(ref))
    assert tuple(got[1].shape) == (2, IMG // 4, IMG // 4, 8)


@pytest.mark.parametrize('rescale', [False, True])
def test_detections_and_masks_of_tpudets_outputs_match(pair, rescale):
    _, jmodel, variables, model = pair
    out = jax.jit(jmodel.apply)(variables, jnp.asarray(_img(5)))
    kw = {}
    if rescale:
        kw['scale_factors'] = np.array([[0.5, 0.6, 0.5, 0.6],
                                        [1.5, 1.25, 1.5, 1.25]], np.float32)
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    ref, ref_masks = jax.jit(jmodel.predict_masks)(out, **jkw)
    ref_res = jax.jit(jmodel.get_bboxes)(out, **jkw)
    t_out = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), out)
    t_kw = {k: torch.from_numpy(v) for k, v in kw.items()}
    res, masks = model.predict_masks(t_out, **t_kw)
    plain = model.get_bboxes(t_out, **t_kw)
    valid = np.asarray(ref.valid)
    assert valid.sum() >= 10 and _mask_mode(model) == 'proto'
    for got in (res, plain):
        np.testing.assert_array_equal(got.valid.numpy(), valid)
        np.testing.assert_array_equal(got.labels.numpy(),
                                      np.asarray(ref.labels))
        np.testing.assert_allclose(got.bboxes.numpy(), np.asarray(ref.bboxes),
                                   atol=1e-4)
        np.testing.assert_allclose(got.scores.numpy(), np.asarray(ref.scores),
                                   atol=1e-6)
    np.testing.assert_allclose(plain.bboxes.numpy(),
                               np.asarray(ref_res.bboxes), atol=1e-4)
    assert masks.shape == ref_masks.shape == (2, 20, 28, 28)
    np.testing.assert_allclose(masks.numpy()[valid],
                               np.asarray(ref_masks)[valid], atol=1e-5)


def test_forward_train_losses_match_tpudet_in_float64(pair):
    cfg, _, variables, _ = pair
    b = batch(23)
    jl, tl = float64_losses(cfg, variables, b)
    assert_losses_match(jl, tl, ['loss_cls', 'loss_bbox', 'loss_mask',
                                 'loss_segm'])
    assert min(tl[k] for k in ('loss_mask', 'loss_bbox')) > 0
    assert_trainer_steps(cfg, b, variables)


def test_a_train_step_matches_tpudet_in_float64():
    from tpudet.train.optim import YoloSGDConfig as JaxSGDConfig
    from tpudet.train.train_state import \
        create_train_state as jax_create_state
    from tpudet.train.train_state import \
        make_train_step as jax_make_train_step
    from tpudet_torch.apis.train import forward_train_loss
    from tpudet_torch.train.optim import YoloSGDConfig
    from tpudet_torch.train.train_state import (create_train_state,
                                                make_train_step)
    from tpudet_torch.utils.flax_import import train_state_to_flax

    from .test_torch_atss_gfl import EMA, OPT, assert_step_matches
    cfg = yolact_cfg()
    jmodel = jax_build_detector(cfg)
    jopt = JaxSGDConfig(**OPT)
    state0 = jax.device_get(jax.jit(
        lambda key, x: jax_create_state(jmodel, key, x, jopt))(
            jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3))))
    state0 = jax.tree.map(lambda a: np.asarray(a, np.float64)
                          if a.dtype == np.float32 else a, state0)
    b = batch(29)

    def loss_fn(params, batch_stats, bt):
        losses, mutated = jmodel.apply(
            {'params': params, 'batch_stats': batch_stats},
            *forward_train_args(jmodel, bt), method='forward_train',
            mutable=['batch_stats'])
        return (sum(v for k, v in losses.items() if 'loss' in k),
                (losses, mutated['batch_stats']))
    with jax.enable_x64(True):
        jstate, jm = jax.device_get(jax.jit(jax_make_train_step(
            jmodel, jopt, loss_fn=loss_fn, **EMA))(
                state0, jax.tree.map(jnp.asarray, b)))
    model = build_detector(cfg)
    load_flax_variables(model, {'params': state0.params,
                                'batch_stats': state0.batch_stats})
    model.double()
    model.dtype = torch.float64
    opt = YoloSGDConfig(**OPT)
    state, tm = make_train_step(model, opt, loss_fn=forward_train_loss(model),
                                **EMA)(create_train_state(model, opt),
                                       {k: torch.from_numpy(v)
                                        for k, v in b.items()})
    assert_step_matches(state0, jstate, {k: float(v) for k, v in jm.items()},
                        train_state_to_flax(state, model),
                        {k: float(v) for k, v in tm.items()},
                        ('loss_cls', 'loss_bbox', 'loss_mask', 'loss_segm'))


def test_single_device_test_proto_mode_matches_tpudet(pair, tmp_path):
    from .test_torch_mask_eval import _assert_masks_one_to_one
    from .test_torch_ms_rcnn_point_rend import shapes_flow
    cfg, _, variables, _ = pair
    got, ref = shapes_flow(tmp_path, cfg, variables, img=IMG)
    assert _assert_masks_one_to_one(got, ref) >= 10
