"""GFL head: port of ``tpudet/models/dense_heads/gfl_head.py``.

ATSS's towers and anchors (one square anchor a cell) with ``gfl_cls`` (C
outputs, the 0.01 prior bias) and ``gfl_reg``: 4 x (``reg_max`` + 1) bin
logits a cell, rounded to fp32 and times the level's ``scales[lvl]``.
The "integral" reads a distance off each side's bins: the softmax over
the bins in fp32 (or wider), its expectation of the bin index, times the
stride; boxes are the anchor centre minus / plus the four distances.

``loss``: the ATSS assigner; the quality focal loss to the detached IoU
of each positive's decoded box with its gt, over ``max(num_pos, 1)``; the
distribution focal loss of the bins to the gt's distances (in strides,
clamped to [0, reg_max - 0.1]) and GIoU of the decoded boxes, both
weighted by the detached best class probability at the positives and
over the weights' sum (clamped at 1e-6; times 4 for the DFL's four
sides). Every denominator counts every rank's batch.

``get_bboxes``: the top ``nms_pre`` of each level by the best class
probability, the integral decoded and clipped to ``img_shape``, then
``batched_nms`` of the top 2048 (box, class) pairs.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...core.assigners import atss_assign_batch
from ...core.bbox import _clip_to, bbox_overlaps_aligned
from ...parallel.mesh import global_sum
from ...registry import HEADS
from .. import losses as L
from .atss_head import (PRIOR_BIAS, LevelAnchors, anchor_centers,
                        finish_bboxes, flat, head_conv, matched_boxes,
                        no_dtype, num_gts, scaled, square_anchors,
                        topk_levels)


def distance_boxes(centers, ltrb):
    """xyxy boxes of centres (..., 2) and side distances (..., 4)."""
    return torch.stack([centers[..., 0] - ltrb[..., 0],
                        centers[..., 1] - ltrb[..., 1],
                        centers[..., 0] + ltrb[..., 2],
                        centers[..., 1] + ltrb[..., 3]], dim=-1)


@HEADS.register_module()
class GFLHead(nn.Module):
    """The keyword arguments are tpudet's fields (``gfl_head.py:25-37``)
    with its defaults. ``scales`` is tpudet's raw ``scales`` leaf (ones)."""

    flax_leaves = {'scales': ('scales', '')}
    leaf_init = {'scales': 1.0}

    def __init__(self, num_classes: int, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 strides: Sequence[int] = (8, 16, 32, 64, 128),
                 octave_base_scale: int = 8, reg_max: int = 16,
                 topk: int = 9, loss_dfl_weight: float = 0.25,
                 loss_bbox_weight: float = 2.0, dtype=None):
        super().__init__()
        no_dtype(type(self).__name__, dtype)
        self.num_classes = num_classes
        self.strides = tuple(strides)
        self.reg_max = reg_max
        self.topk = topk
        self.loss_dfl_weight = loss_dfl_weight
        self.loss_bbox_weight = loss_bbox_weight
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
        self.gfl_cls = head_conv(cin, num_classes, bias_init=PRIOR_BIAS)
        self.gfl_reg = head_conv(cin, 4 * (reg_max + 1))
        self.scales = nn.Parameter(torch.ones(len(self.strides)))

    def forward(self, feats):
        """NCHW features -> (class logits, bin logits (fp32, scaled)),
        per-level (B, H, W, attrib) tuples."""
        cls_out, reg_out = [], []
        for lvl, feat in enumerate(feats):
            c = r = feat
            for i in range(self.stacked_convs):
                c = F.relu(getattr(self, f'cls_conv{i}')(c))
                r = F.relu(getattr(self, f'reg_conv{i}')(r))
            cls_out.append(self.gfl_cls(c).permute(0, 2, 3, 1))
            reg_out.append(scaled(self.gfl_reg(r),
                                  self.scales[lvl]).permute(0, 2, 3, 1))
        return tuple(cls_out), tuple(reg_out)

    def integral(self, reg_logits):
        """(..., 4 (reg_max + 1)) bin logits -> (..., 4) expected distances
        in strides: the softmax over each side's bins (fp32 or wider)
        against the bin indices."""
        p = F.softmax(reg_logits.reshape(reg_logits.shape[:-1] +
                                         (4, self.reg_max + 1)), dim=-1)
        bins = torch.arange(self.reg_max + 1, dtype=torch.float32,
                            device=p.device)
        return (p * bins).sum(dim=-1)

    def loss(self, preds, gt_bboxes, gt_labels, gt_valid
             ) -> Dict[str, torch.Tensor]:
        """``loss_cls`` (QFL), ``loss_bbox`` (GIoU), ``loss_dfl`` and
        ``num_gts`` (``gfl_head.py:97-167``)."""
        return self.loss_and_weights(preds, gt_bboxes, gt_labels,
                                     gt_valid)[0]

    def loss_and_weights(self, preds, gt_bboxes, gt_labels, gt_valid
                         ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """``loss``'s dict and the (B, A) weights of its DFL and GIoU terms
        (the detached best class probability at the positives, 0
        elsewhere), which the LD term reuses."""
        cls_scores, reg_logits = preds
        _, anchors, counts = self._anchors(cls_scores)
        centers = anchor_centers(anchors)
        stride_per_anchor = torch.cat([
            anchors.new_full((n,), float(s))
            for n, s in zip(counts, self.strides)])
        b, nc, nb = cls_scores[0].shape[0], self.num_classes, self.reg_max + 1
        cls_flat = flat([c.float() for c in cls_scores], b, nc)
        reg_flat = flat(reg_logits, b, 4 * nb)
        gt_bboxes = gt_bboxes.float()

        assigned = atss_assign_batch(anchors, counts, gt_bboxes, gt_valid,
                                     self.topk)
        pos = assigned >= 0
        num_pos = torch.clamp_min(global_sum(pos.float().sum()), 1.0)
        gt_idx = assigned.clamp_min(0)
        matched = matched_boxes(gt_bboxes, gt_idx)

        dists = self.integral(reg_flat) * stride_per_anchor[None, :, None]
        pred_boxes = distance_boxes(centers[None], dists)
        quality = bbox_overlaps_aligned(pred_boxes, matched).detach() * pos
        labels = torch.where(pos, torch.gather(gt_labels.long(), 1, gt_idx),
                             nc)
        loss_qfl = L.quality_focal_loss(cls_flat, labels, quality,
                                        avg_factor=num_pos)

        w = torch.sigmoid(cls_flat).amax(dim=-1).detach() * pos
        w_sum = torch.clamp_min(global_sum(w.sum()), 1e-6)
        # the gt's distances in strides, clamped as bbox2distance does
        sides = torch.stack([
            centers[None, :, 0] - matched[..., 0],
            centers[None, :, 1] - matched[..., 1],
            matched[..., 2] - centers[None, :, 0],
            matched[..., 3] - centers[None, :, 1]], dim=-1)
        tgt = torch.clamp(sides / stride_per_anchor[None, :, None], 0,
                          self.reg_max - 0.1)
        loss_dfl = L.distribution_focal_loss(
            reg_flat.reshape(b, -1, 4, nb), tgt,
            weight=w[..., None] * pos[..., None], avg_factor=w_sum * 4,
            loss_weight=self.loss_dfl_weight)
        loss_bbox = L.giou_loss(pred_boxes, matched, weight=w,
                                avg_factor=w_sum,
                                loss_weight=self.loss_bbox_weight)
        return dict(loss_cls=loss_qfl, loss_bbox=loss_bbox,
                    loss_dfl=loss_dfl, num_gts=num_gts(gt_valid)), w

    def get_bboxes(self, preds, scale_factors=None, score_thr: float = 0.05,
                   iou_thr: float = 0.6, max_per_img: int = 100,
                   nms_pre: int = 1000, img_shape=None, with_nms: bool = True,
                   **kwargs):
        """Decode and NMS (``gfl_head.py:170-213``), batched, in fp32.
        ``img_shape`` is ``(h, w)``: numbers or per-image (B, 1) columns.
        Returns NMSResult, or with ``with_nms=False`` ``(boxes, scores)``
        without a background column. Other keywords are ignored, as tpudet
        ignores them."""
        cls_scores, reg_logits = preds
        levels, _, _ = self._anchors(cls_scores)
        b, nc, nb = cls_scores[0].shape[0], self.num_classes, self.reg_max + 1
        all_boxes, all_scores = [], []
        for lvl, anchors in enumerate(levels):
            centers = anchor_centers(anchors)
            scores = torch.sigmoid(cls_scores[lvl].reshape(b, -1, nc).float())
            reg = reg_logits[lvl].reshape(b, -1, 4 * nb)
            n = scores.shape[1]
            k = min(nms_pre, n) if with_nms else 0
            if 0 < k < n:
                scores, reg, lvl_centers = topk_levels(scores, k, reg,
                                                       centers)
            else:
                lvl_centers = centers[None].expand(b, -1, -1)
            boxes = distance_boxes(lvl_centers, self.integral(reg) *
                                   float(self.strides[lvl]))
            if img_shape is not None:  # distance2bbox's max_shape clip
                boxes = torch.stack([
                    _clip_to(boxes[..., 0], img_shape[1]),
                    _clip_to(boxes[..., 1], img_shape[0]),
                    _clip_to(boxes[..., 2], img_shape[1]),
                    _clip_to(boxes[..., 3], img_shape[0])], dim=-1)
            all_boxes.append(boxes)
            all_scores.append(scores)
        return finish_bboxes(all_boxes, all_scores, scale_factors, score_thr,
                             iou_thr, max_per_img, with_nms)
