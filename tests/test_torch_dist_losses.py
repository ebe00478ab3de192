"""The loss denominators under a process group: on two gloo ranks (one OS
process each, ``tests/torch_fixtures/dist.py``) every loss is the rank's
share, and the shares add up to the loss of the whole batch.

- The heads' losses against tpudet's on the whole batch, fp32, rtol 1e-5
  (the tolerance of the heads' own tests): ``YOLOCSPHead`` (``num_pos`` a
  level and the conf mean), ``RetinaHead`` (``num_pos``), ``RPNHead``
  (``num_total``), ``StandardRoIHead`` (``num_total``) and the mask head's
  ``mask_loss`` (``denom``), on random inputs whose two halves hold
  unequal numbers of positives; ``num_gts`` is a share too.
- A narrow Mask R-CNN's ``forward_train`` in float64 (the RPN, RoI and
  mask losses, ResNet's BatchNorm synced) against the same code on the
  whole batch in one process, rtol 1e-5 (the RPN and RoI heads compute
  their losses in fp32 in a float64 model, as tpudet's do; the sums run
  in other orders); that one-process loss is held
  against tpudet's by ``test_torch_mask_rcnn.py``
  (``test_mask_rcnn_forward_train_matches_tpudet_in_float64``).
- Each rank alone, dividing by its own counts, and the two averaged (what
  averaging per-rank losses in DDP computes) misses tpudet's global loss
  by far more than the tolerance.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpudet.models.builder import build_head as jax_build_head
from tpudet_torch.models.builder import build_detector
from tpudet_torch.utils.flax_import import random_flax_variables

from .test_torch_mask_rcnn import (_img, _loss_inputs, frame_masks,
                                   mask_rcnn_cfg)
from .test_torch_rpn_head import gts
from .torch_fixtures.dist import (Ranks, forward_train_job, head_losses,
                                  losses_job)
from . import torch_fixtures  # noqa: F401  (one intra-op thread)

WORLD, RTOL = 2, 1e-5
IMG, NUM_CLASSES, CH = 128, 3, 32


def _levels(rng, b, attrib, strides, anchors=3):
    return [rng.randn(b, IMG // s, IMG // s, anchors * attrib).astype(
        np.float32) for s in strides]


def head_cases():
    """``{name: (cfg, method, args)}``: tpudet's and the port's head of
    each cfg take the same args. Image 0 holds 6 gts, image 1 two."""
    rng = np.random.RandomState(0)
    boxes, labels, valid = gts(3, size=IMG)
    yolo = dict(type='YOLOCSPHead', num_classes=NUM_CLASSES,
                in_channels=[CH, CH, CH])
    retina = dict(type='RetinaHead', num_classes=NUM_CLASSES,
                  in_channels=CH, feat_channels=CH, stacked_convs=1)
    rpn = dict(type='RPNHead', in_channels=CH, feat_channels=CH)
    roi = dict(type='StandardRoIHead', num_classes=NUM_CLASSES,
               in_channels=CH)
    mask = dict(type='MaskRoIHead', num_classes=NUM_CLASSES, in_channels=CH)
    s = 64  # RoI slots an image
    pos = np.zeros((2, s), bool)
    pos[0, :20], pos[1, :3] = True, True
    sampled = pos | (rng.rand(2, s) > 0.3)
    m = _loss_inputs(4)
    m['pos'][1] = False
    m['pos'][1, :2] = True
    return {
        'yolo': (yolo, 'loss', (
            tuple(_levels(rng, 2, 5 + NUM_CLASSES, (8, 16, 32))),
            boxes, labels, valid)),
        'retina': (retina, 'loss', (
            (tuple(_levels(rng, 2, NUM_CLASSES, (8, 16, 32, 64, 128), 9)),
             tuple(_levels(rng, 2, 4, (8, 16, 32, 64, 128), 9))),
            boxes, labels, valid)),
        'rpn': (rpn, 'loss', (
            (tuple(_levels(rng, 2, 1, (4, 8, 16, 32, 64))),
             tuple(_levels(rng, 2, 4, (4, 8, 16, 32, 64)))),
            boxes, labels, valid)),
        'roi': (roi, 'loss', (
            rng.randn(2, s, NUM_CLASSES + 1).astype(np.float32),
            rng.randn(2, s, 4 * NUM_CLASSES).astype(np.float32),
            np.where(pos, rng.randint(0, NUM_CLASSES, (2, s)), NUM_CLASSES),
            rng.randn(2, s, 4).astype(np.float32), pos, sampled)),
        'mask': (mask, 'mask_loss', tuple(m[k] for k in (
            'mask_logits', 'rois', 'pos', 'gt_idx', 'gt_boxes',
            'gt_frame_masks', 'labels'))),
    }


def _jnp(x):
    if isinstance(x, (tuple, list)):
        return type(x)(_jnp(v) for v in x)
    return jnp.asarray(x)


def tpudet_head_losses(cases):
    out = {}
    for name, (cfg, method, args) in cases.items():
        head = jax_build_head(dict(cfg))
        losses = jax.jit(partial(head.apply, {'params': {}},
                                 method=method))(*_jnp(args))
        out[name] = {k: float(v) for k, v in losses.items()}
    return out


@pytest.fixture(scope='module')
def mask_rcnn():
    """The narrow Mask R-CNN of ``test_torch_mask_rcnn.py``, tpudet's init
    drawn by the port, and a batch of 2 images: 6 gts and 2."""
    cfg = mask_rcnn_cfg()
    variables = random_flax_variables(build_detector(cfg), seed=6)
    boxes, labels, valid = gts(3, size=96)
    batch = dict(img=_img(7).astype(np.float64), gt_bboxes=boxes,
                 gt_labels=labels, gt_valid=valid,
                 gt_frame_masks=frame_masks(9))
    return cfg, variables, batch


@pytest.fixture(scope='module')
def runs(mask_rcnn, tmp_path_factory):
    cases = head_cases()
    ranks = Ranks(losses_job, WORLD, tmp_path_factory.mktemp('losses'),
                  cases, *mask_rcnn)
    ref = tpudet_head_losses(cases)
    return cases, ref, ranks.join()


def _summed(shares):
    return {k: sum(s[k] for s in shares) for k in shares[0]}


@pytest.mark.parametrize('head', ['yolo', 'retina', 'rpn', 'roi', 'mask'])
def test_the_ranks_shares_add_up_to_tpudets_loss(runs, head):
    _, ref, ranks = runs
    got = _summed([heads[head] for heads, _ in ranks])
    assert set(got) == set(ref[head])
    for k, v in ref[head].items():
        np.testing.assert_allclose(got[k], v, rtol=RTOL, err_msg=k)
    assert any(v > 0 for k, v in ref[head].items() if 'loss' in k)


@pytest.mark.parametrize('head', ['yolo', 'retina', 'roi', 'mask'])
def test_per_rank_denominators_would_miss_it(runs, head):
    """Each half alone (no group: its own counts), averaged over the
    ranks: another model's loss. (The RPN samples 256 anchors an image,
    so its count is the same in every image and the two agree there.)"""
    cases, ref, _ = runs
    alone = [head_losses({head: cases[head]}, r, WORLD)[head]
             for r in range(WORLD)]
    mean = {k: np.mean([a[k] for a in alone]) for k in alone[0]}
    worst = max(abs(mean[k] - v) / abs(v) for k, v in ref[head].items()
                if 'loss' in k and v)
    assert worst > 100 * RTOL


def test_mask_rcnn_forward_train_shares_add_up(runs, mask_rcnn):
    cfg, variables, batch = mask_rcnn
    whole = forward_train_job(0, 1, cfg, variables, batch)
    got = _summed([f for _, f in runs[2]])
    assert set(got) == set(whole) and 'loss_mask' in got
    for k, v in whole.items():
        np.testing.assert_allclose(got[k], v, rtol=RTOL, err_msg=k)
