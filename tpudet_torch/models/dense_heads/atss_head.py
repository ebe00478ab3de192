"""ATSS head: port of ``tpudet/models/dense_heads/atss_head.py``.

RetinaNet-style towers (``cls_conv{i}``, ``reg_conv{i}``, 3x3 + ReLU) with
one square anchor a cell (``octave_base_scale`` 8), ``atss_cls`` (C
outputs, the 0.01 prior bias), ``atss_reg`` (4 deltas, times the level's
learnable ``scales[lvl]`` in fp32) and ``atss_centerness`` on the
regression tower; every conv N(0, 0.01^2). Pred maps leave the head in
tpudet's layout, (B, H, W, attrib).

``loss``: the ATSS assigner (``core/assigners.atss_assign_batch``); the
sigmoid focal loss over ``max(num_pos, 1)``; GIoU of the boxes that
``DeltaXYWHBBoxCoder(target_stds=(.1, .1, .2, .2))`` decodes from the
anchors, weighted by the centerness target, over its sum clamped at 1;
BCE of the centerness at the positives over ``max(num_pos, 1)``. Every
denominator counts every rank's batch.

``get_bboxes``: the class probabilities times the centerness probability,
the top ``nms_pre`` of each level by their best score (ties by index),
the deltas decoded and clipped to ``img_shape``, then ``batched_nms`` of
the top 2048 (box, class) pairs.

The helpers below serve the family (GFL, LD, VFNet): ``scaled`` rounds a
regression map to fp32 and multiplies it by a level's scale as tpudet
does, ``LevelAnchors`` caches the anchors of the pred maps' sizes.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...core.anchors import AnchorGenerator
from ...core.assigners import atss_assign_batch
from ...core.bbox import DeltaXYWHBBoxCoder
from ...core.nms import batched_nms, topk_scores
from ...parallel.mesh import global_count, global_sum
from ...registry import HEADS
from .. import losses as L
from ..layers import Conv

PRIOR_BIAS = float(-math.log((1 - 0.01) / 0.01))  # class scores start at 0.01


def head_conv(cin, cout, bias=True, bias_init=0.):
    """A 3x3 'SAME' conv drawn N(0, 0.01^2), as every conv of the family's
    heads."""
    return Conv(cin, cout, 3, 1, 1, bias=bias, kernel_init=('normal', 0.01),
                bias_init=bias_init)


def scaled(x, scale):
    """tpudet's ``x.astype(float32) * scales[lvl]``: rounded to fp32 first,
    then computed in the promotion of fp32 and the scale's dtype (float64
    in a float64 run: jnp promotes with a 0-d array, torch would not)."""
    return x.float().to(torch.promote_types(torch.float32, scale.dtype)) * \
        scale


def no_dtype(head: str, dtype):
    """Heads take no compute dtype; the detector's ``set_dtype`` sets it."""
    if dtype is not None:
        raise ValueError(f'{head}: dtype={dtype!r} is not a module setting '
                         f'in the port; see SingleStageDetector.set_dtype')


class LevelAnchors:
    """Per-level anchors of ``generator`` for the pred maps' (H, W) sizes,
    the levels' concatenation and their counts, on the maps' device,
    cached per sizes and device."""

    def __init__(self, generator: AnchorGenerator):
        self.generator = generator
        self._grids: Dict = {}

    def __call__(self, cls_scores):
        sizes = tuple(tuple(c.shape[1:3]) for c in cls_scores)
        dev = cls_scores[0].device
        key = (sizes, dev)
        if key not in self._grids:
            levels = self.generator.grid_anchors(sizes)
            self._grids[key] = (
                [torch.from_numpy(a).to(dev) for a in levels],
                torch.from_numpy(np.concatenate(levels)).to(dev),
                [len(a) for a in levels])
        return self._grids[key]


def anchor_centers(anchors):
    """(..., 4) xyxy -> (..., 2) centres."""
    return torch.stack([(anchors[..., 0] + anchors[..., 2]) * 0.5,
                        (anchors[..., 1] + anchors[..., 3]) * 0.5], -1)


def square_anchors(strides, octave_base_scale):
    """One square anchor a cell, ``octave_base_scale`` strides wide."""
    return AnchorGenerator(strides=list(strides), ratios=[1.0],
                           octave_base_scale=octave_base_scale,
                           scales_per_octave=1)


def flat(maps, b: int, width: int):
    """Per-level (B, H, W, width) maps -> (B, sum H W, width)."""
    return torch.cat([m.reshape(b, -1, width) for m in maps], dim=1)


def matched_boxes(gt_bboxes, gt_idx):
    """(B, G, 4) gts gathered at (B, A) indices -> (B, A, 4)."""
    return torch.gather(gt_bboxes, 1, gt_idx[..., None].expand(-1, -1, 4))


def num_gts(gt_valid):
    """The mean count of valid gts an image, over every rank's batch."""
    return gt_valid.float().sum() / global_count(gt_valid.shape[0],
                                                 gt_valid.device)


def topk_levels(scores, k: int, *payload):
    """The top ``k`` rows of (B, N, C) ``scores`` by their best class
    (ties by index) and of each (B, N, ...) or (N, ...) payload; the
    payloads gathered at the same rows."""
    _, idx = topk_scores(scores.amax(dim=-1), k)
    out = [torch.gather(scores, 1, idx[..., None].expand(-1, -1,
                                                        scores.shape[-1]))]
    for p in payload:
        if p.dim() == 2:  # shared by the batch: (N, d)
            out.append(p[idx])
        else:
            out.append(torch.gather(p, 1, idx[..., None].expand(
                -1, -1, p.shape[-1])))
    return out


def finish_bboxes(boxes, scores, scale_factors, score_thr, iou_thr,
                  max_per_img, with_nms):
    """The levels' candidates concatenated, divided by ``scale_factors``,
    then ``batched_nms`` of the top 2048 (box, class) pairs, or ``(boxes,
    scores)`` with ``with_nms=False`` (no background column)."""
    bbox = torch.cat(boxes, dim=1)
    scores = torch.cat(scores, dim=1)
    if scale_factors is not None:
        scale_factors = torch.as_tensor(scale_factors, dtype=bbox.dtype,
                                        device=bbox.device)
        bbox = bbox / scale_factors[:, None, :]
    if not with_nms:
        return bbox, scores
    return batched_nms(bbox, scores, score_thr, iou_thr, max_per_img,
                       nms_pre=2048)


@HEADS.register_module()
class ATSSHead(nn.Module):
    """The keyword arguments are tpudet's fields (``atss_head.py:28-40``)
    with its defaults. ``scales`` is tpudet's raw ``scales`` leaf (ones)."""

    flax_leaves = {'scales': ('scales', '')}
    leaf_init = {'scales': 1.0}

    def __init__(self, num_classes: int, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 strides: Sequence[int] = (8, 16, 32, 64, 128),
                 octave_base_scale: int = 8, topk: int = 9,
                 focal_gamma: float = 2.0, focal_alpha: float = 0.25,
                 loss_bbox_weight: float = 2.0,
                 target_stds: Sequence[float] = (0.1, 0.1, 0.2, 0.2),
                 dtype=None):
        super().__init__()
        no_dtype('ATSSHead', dtype)
        self.num_classes = num_classes
        self.strides = tuple(strides)
        self.topk = topk
        self.focal_gamma = focal_gamma
        self.focal_alpha = focal_alpha
        self.loss_bbox_weight = loss_bbox_weight
        self.bbox_coder = DeltaXYWHBBoxCoder(target_stds=target_stds)
        self.anchor_generator = square_anchors(self.strides,
                                               octave_base_scale)
        self._anchors = LevelAnchors(self.anchor_generator)
        self.stacked_convs = stacked_convs
        for branch in ('cls', 'reg'):
            cin = in_channels
            for i in range(stacked_convs):
                self.add_module(f'{branch}_conv{i}',
                                head_conv(cin, feat_channels))
                cin = feat_channels
        self.atss_cls = head_conv(cin, num_classes, bias_init=PRIOR_BIAS)
        self.atss_reg = head_conv(cin, 4)
        self.atss_centerness = head_conv(cin, 1)
        self.scales = nn.Parameter(torch.ones(len(self.strides)))

    def forward(self, feats):
        """NCHW features -> (class logits, deltas (fp32, scaled),
        centerness logits), per-level (B, H, W, attrib) tuples."""
        cls_out, reg_out, ctr_out = [], [], []
        for lvl, feat in enumerate(feats):
            c = r = feat
            for i in range(self.stacked_convs):
                c = F.relu(getattr(self, f'cls_conv{i}')(c))
                r = F.relu(getattr(self, f'reg_conv{i}')(r))
            cls_out.append(self.atss_cls(c).permute(0, 2, 3, 1))
            reg_out.append(scaled(self.atss_reg(r),
                                  self.scales[lvl]).permute(0, 2, 3, 1))
            ctr_out.append(self.atss_centerness(r).permute(0, 2, 3, 1))
        return tuple(cls_out), tuple(reg_out), tuple(ctr_out)

    def loss(self, preds, gt_bboxes, gt_labels, gt_valid
             ) -> Dict[str, torch.Tensor]:
        """``loss_cls``, ``loss_bbox``, ``loss_centerness`` and ``num_gts``
        (``atss_head.py:99-159``), in fp32 or wider. gt_bboxes (B, G, 4)
        zero-padded xyxy, gt_labels (B, G), gt_valid (B, G)."""
        cls_scores, bbox_preds, centernesses = preds
        _, anchors, counts = self._anchors(cls_scores)
        centers = anchor_centers(anchors)
        b, nc = cls_scores[0].shape[0], self.num_classes
        cls_flat = flat([c.float() for c in cls_scores], b, nc)
        reg_flat = flat([r.float() for r in bbox_preds], b, 4)
        ctr_flat = flat([c.float() for c in centernesses], b, 1)[..., 0]
        gt_bboxes = gt_bboxes.float()

        assigned = atss_assign_batch(anchors, counts, gt_bboxes, gt_valid,
                                     self.topk)
        pos = assigned >= 0
        num_pos = torch.clamp_min(global_sum(pos.float().sum()), 1.0)
        gt_idx = assigned.clamp_min(0)
        labels = torch.gather(gt_labels.long(), 1, gt_idx)
        onehot = L.one_hot(labels, nc, torch.float32) * pos[..., None]
        loss_cls = L.sigmoid_focal_loss(
            cls_flat, onehot, gamma=self.focal_gamma, alpha=self.focal_alpha,
            avg_factor=num_pos)

        matched = matched_boxes(gt_bboxes, gt_idx)
        # the centerness target from the anchor centre's distances to the
        # gt's sides
        left = centers[None, :, 0] - matched[..., 0]
        top = centers[None, :, 1] - matched[..., 1]
        right = matched[..., 2] - centers[None, :, 0]
        bottom = matched[..., 3] - centers[None, :, 1]
        lr = (torch.minimum(left, right) /
              torch.clamp_min(torch.maximum(left, right), 1e-6))
        tb = (torch.minimum(top, bottom) /
              torch.clamp_min(torch.maximum(top, bottom), 1e-6))
        ctr_tgt = torch.sqrt(torch.clamp(lr * tb, 0., 1.))
        ctr_tgt = torch.where(pos, ctr_tgt, torch.zeros_like(ctr_tgt))

        pred_boxes = self.bbox_coder.decode(anchors[None], reg_flat)
        w = ctr_tgt * pos
        loss_bbox = L.giou_loss(
            pred_boxes, matched, weight=w,
            avg_factor=torch.clamp_min(global_sum(w.sum()), 1.0),
            loss_weight=self.loss_bbox_weight)
        loss_ctr = L.bce_loss(ctr_flat, ctr_tgt, weight=pos.float(),
                              avg_factor=num_pos)
        return dict(loss_cls=loss_cls, loss_bbox=loss_bbox,
                    loss_centerness=loss_ctr, num_gts=num_gts(gt_valid))

    def get_bboxes(self, preds, scale_factors=None, score_thr: float = 0.05,
                   iou_thr: float = 0.6, max_per_img: int = 100,
                   nms_pre: int = 1000, img_shape=None, with_nms: bool = True,
                   **kwargs):
        """Decode and NMS (``atss_head.py:162-201``), batched, in fp32.
        ``img_shape`` is ``(h, w)``: numbers or per-image (B, 1) columns.
        Returns NMSResult, or with ``with_nms=False`` ``(boxes (B, N, 4),
        scores (B, N, C))``. Other keywords (``nms_type``) are ignored, as
        tpudet ignores them."""
        cls_scores, bbox_preds, centernesses = preds
        levels, _, _ = self._anchors(cls_scores)
        b, nc = cls_scores[0].shape[0], self.num_classes
        all_boxes, all_scores = [], []
        for lvl, anchors in enumerate(levels):
            scores = torch.sigmoid(cls_scores[lvl].reshape(b, -1, nc).float())
            ctr = torch.sigmoid(centernesses[lvl].reshape(b, -1).float())
            scores = scores * ctr[..., None]
            deltas = bbox_preds[lvl].reshape(b, -1, 4).float()
            n = scores.shape[1]
            k = min(nms_pre, n) if with_nms else 0
            if 0 < k < n:
                scores, deltas, lvl_anchors = topk_levels(scores, k, deltas,
                                                          anchors)
            else:
                lvl_anchors = anchors[None].expand(b, -1, -1)
            all_boxes.append(self.bbox_coder.decode(lvl_anchors, deltas,
                                                    max_shape=img_shape))
            all_scores.append(scores)
        return finish_bboxes(all_boxes, all_scores, scale_factors, score_thr,
                             iou_thr, max_per_img, with_nms)
