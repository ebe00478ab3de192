"""Targets, boxes, losses and the head loss: tpudet_torch against tpudet on
the CPU, in fp32, on inputs from a numpy seed.

Tolerances: ``responsible_matches`` exactly equal (both compute the same
fp32 arithmetic, then compare); ``bbox_overlaps_aligned`` (iou, giou),
``giou_loss`` and the BCE atol 1e-6; ``YOLOCSPHead.loss`` values and its
gradients with respect to the pred maps rtol 1e-5 (fp32 means over a few
thousand anchors, summed in other orders). Boxes and logits are drawn
continuous, so no ``max`` or ``clip`` meets a tie.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet.core.anchors import YOLOV4AnchorGenerator as JaxAnchorGenerator
from tpudet.core.bbox import bbox_overlaps_aligned as jax_overlaps
from tpudet.core.targets import responsible_matches as jax_matches
from tpudet.models import losses as JL
from tpudet.models.dense_heads.yolocsp_head import YOLOCSPHead as JaxHead
from tpudet_torch.core.anchors import YOLOV4AnchorGenerator
from tpudet_torch.core.bbox import bbox_overlaps_aligned
from tpudet_torch.core.targets import (multilevel_responsible_matches,
                                       responsible_matches)
from tpudet_torch.models import losses as TL
from tpudet_torch.models.dense_heads.yolocsp_head import (DEFAULT_BASE_SIZES,
                                                          YOLOCSPHead)

IMG, NUM_CLASSES, STRIDES = 128, 5, (8, 16, 32)


def padded_gts(seed, batch=3, g_max=6, size=IMG):
    """Random gts with padding, boxes on the image border and boxes whose
    centres sit on cell edges (xy % 1 == 0.5 and == 0 on a grid)."""
    rng = np.random.RandomState(seed)
    gt = np.zeros((batch, g_max, 4), np.float32)
    valid = np.zeros((batch, g_max), bool)
    for i in range(batch):
        n = rng.randint(0 if i == 0 else 1, g_max + 1)
        wh = rng.uniform(4, size * 0.8, (n, 2))
        c = rng.uniform(0, size, (n, 2))
        box = np.concatenate([c - wh / 2, c + wh / 2], -1)
        gt[i, :n] = np.clip(box, 0, size)
        valid[i, :n] = True
    gt[-1, 0] = [0, 0, 40, 36]  # touches two borders
    gt[-1, 1] = [8, 8, 24, 24]  # centre 16: on a cell corner at stride 8/16
    gt[-1, 2] = [100, 90, 128, 128]
    valid[-1, :3] = True
    labels = rng.randint(0, NUM_CLASSES, (batch, g_max)).astype(np.int32)
    labels[~valid] = -1  # arbitrary at padding
    return gt, labels, valid


def test_base_anchor_wh_matches_tpudet():
    sizes = [list(b) for b in DEFAULT_BASE_SIZES]
    got = YOLOV4AnchorGenerator(list(STRIDES), sizes).base_anchor_wh()
    ref = JaxAnchorGenerator(list(STRIDES), sizes).base_anchor_wh()
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize('neighbor', [0, 2, 3])
@pytest.mark.parametrize('seed', [0, 1])
def test_responsible_matches_exactly_equal(seed, neighbor):
    gt, _, valid = padded_gts(seed)
    whs = YOLOV4AnchorGenerator(
        list(STRIDES), [list(b) for b in DEFAULT_BASE_SIZES]).base_anchor_wh()
    for lvl, stride in enumerate(STRIDES):
        size = (IMG // stride, IMG // stride)
        ref = jax_matches(jnp.asarray(gt), jnp.asarray(valid), size,
                          float(stride), whs[lvl], neighbor=neighbor)
        got = responsible_matches(torch.from_numpy(gt),
                                  torch.from_numpy(valid), size,
                                  float(stride), whs[lvl], neighbor=neighbor)
        assert got.anchor_idx.shape == ref.anchor_idx.shape  # (B, G, A, O)
        np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
        np.testing.assert_array_equal(got.anchor_idx.numpy(),
                                      np.asarray(ref.anchor_idx))
    assert got.mask.any() and not got.mask[~torch.from_numpy(valid)].any()


def test_multilevel_matches_are_the_levels():
    gt, _, valid = padded_gts(2)
    whs = YOLOV4AnchorGenerator(
        list(STRIDES), [list(b) for b in DEFAULT_BASE_SIZES]).base_anchor_wh()
    sizes = [(IMG // s, IMG // s) for s in STRIDES]
    gt_t, valid_t = torch.from_numpy(gt), torch.from_numpy(valid)
    levels = multilevel_responsible_matches(gt_t, valid_t, sizes,
                                            [float(s) for s in STRIDES], whs)
    for lvl, m in enumerate(levels):
        one = responsible_matches(gt_t, valid_t, sizes[lvl],
                                  float(STRIDES[lvl]), whs[lvl])
        assert torch.equal(m.anchor_idx, one.anchor_idx)
        assert torch.equal(m.mask, one.mask)


def _box_pairs(seed, n=2000):
    rng = np.random.RandomState(seed)
    a = rng.uniform(0, 100, (n, 2))
    b = a + rng.uniform(-30, 30, (n, 2))
    wa, wb = rng.uniform(1, 50, (n, 2)), rng.uniform(1, 50, (n, 2))
    return (np.concatenate([a, a + wa], -1).astype(np.float32),
            np.concatenate([b, b + wb], -1).astype(np.float32))


@pytest.mark.parametrize('mode', ['iou', 'giou'])
def test_bbox_overlaps_aligned(mode):
    b1, b2 = _box_pairs(0)
    got = bbox_overlaps_aligned(torch.from_numpy(b1), torch.from_numpy(b2),
                                mode=mode).numpy()
    ref = np.asarray(jax_overlaps(jnp.asarray(b1), jnp.asarray(b2),
                                  mode=mode))
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    assert (got <= 0).any() if mode == 'giou' else (got == 0).any()


def test_giou_loss_and_reductions():
    b1, b2 = _box_pairs(1)
    w = np.random.RandomState(2).rand(len(b1)).astype(np.float32)
    t1, t2, tw = map(torch.from_numpy, (b1, b2, w))
    for kw in (dict(reduction='none'), dict(reduction='mean'),
               dict(reduction='sum'), dict(weight=True, avg_factor=7.0),
               dict(weight=True)):
        jkw = dict(kw, weight=jnp.asarray(w)) if 'weight' in kw else kw
        tkw = dict(kw, weight=tw) if 'weight' in kw else kw
        got = TL.giou_loss(t1, t2, **tkw).numpy()
        ref = np.asarray(JL.giou_loss(jnp.asarray(b1), jnp.asarray(b2),
                                      **jkw))
        np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-6)


def test_binary_cross_entropy_with_logits():
    rng = np.random.RandomState(3)
    pred = (rng.randn(5000) * 6).astype(np.float32)
    target = rng.rand(5000).astype(np.float32)
    got = TL.binary_cross_entropy_with_logits(torch.from_numpy(pred),
                                              torch.from_numpy(target))
    ref = JL.binary_cross_entropy_with_logits(jnp.asarray(pred),
                                              jnp.asarray(target))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


def _pred_maps(seed, batch=3):
    rng = np.random.RandomState(seed)
    attrib = 5 + NUM_CLASSES
    return [(rng.randn(batch, IMG // s, IMG // s, 3 * attrib) * 1.5).astype(
        np.float32) for s in STRIDES]


HEAD_KW = [dict(), dict(one_hot_smoother=0.1, conf_iou_loss_ratio=0.5,
                        shape_match_thres=3.0)]


@pytest.mark.parametrize('kw', HEAD_KW, ids=['defaults', 'fields'])
def test_head_loss_values_and_gradients(kw):
    gt, labels, valid = padded_gts(4)
    maps = _pred_maps(5)
    jhead = JaxHead(num_classes=NUM_CLASSES, in_channels=[8, 8, 8], **kw)
    head = YOLOCSPHead(NUM_CLASSES, [8, 8, 8], **kw)
    keys = ('loss_cls', 'loss_conf', 'loss_bbox')

    def jax_total(maps_):
        out = jhead.loss(tuple(maps_), jnp.asarray(gt), jnp.asarray(labels),
                         jnp.asarray(valid))
        return sum(out[k] for k in keys), out

    (ref_total, ref), ref_grads = jax.value_and_grad(
        jax_total, has_aux=True)([jnp.asarray(m) for m in maps])
    tmaps = [torch.from_numpy(m).requires_grad_() for m in maps]
    got = head.loss(tmaps, torch.from_numpy(gt), torch.from_numpy(labels),
                    torch.from_numpy(valid))
    sum(got[k] for k in keys).backward()
    for k in keys + ('num_gts',):
        np.testing.assert_allclose(float(got[k].detach()), float(ref[k]),
                                   rtol=1e-5,
                                   err_msg=k)
    for t, r in zip(tmaps, ref_grads):
        r = np.asarray(r)
        scale = np.abs(r).max()
        assert scale > 0
        np.testing.assert_allclose(t.grad.numpy(), r, atol=1e-5 * scale,
                                   rtol=1e-5)


def test_head_loss_in_fp32_from_bf16_maps():
    """bf16 pred maps (the training forward's) give an fp32 loss and bf16
    gradients."""
    gt, labels, valid = padded_gts(6)
    head = YOLOCSPHead(NUM_CLASSES, [8, 8, 8])
    maps = [torch.from_numpy(m).to(torch.bfloat16).requires_grad_()
            for m in _pred_maps(7)]
    out = head.loss(maps, torch.from_numpy(gt), torch.from_numpy(labels),
                    torch.from_numpy(valid))
    total = out['loss_cls'] + out['loss_conf'] + out['loss_bbox']
    assert total.dtype == torch.float32 and torch.isfinite(total)
    total.backward()
    assert all(m.grad.dtype == torch.bfloat16 for m in maps)
