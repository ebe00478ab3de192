"""SABL RetinaNet head: port of
``tpudet/models/dense_heads/sabl_retina_head.py`` (``SABLRetinaHead``).

Side-aware boundary localization on one square anchor a cell (4 strides
wide): RetinaNet's towers of ``stacked_convs`` 3x3 convs with ReLU
(``cls_conv{i}``, ``reg_conv{i}``), then ``retina_cls`` (C logits, the
0.01 prior bias), ``retina_bbox_cls`` (bucket logits) and
``retina_bbox_reg`` (bucket offsets), 4 x 7 each, every conv N(0, 0.01^2).
Pred maps leave the head in tpudet's layout, (B, H, W, attrib).

``loss`` (``sabl_retina_head.py:123-193``): every cell is assigned by the
approx-max-IoU rule over its 3 x 3 approx anchors
(``core/assigners.approx_max_iou_assign_batch``, every gt claiming its
best cells); the focal loss over positives and negatives; on the
positives the bucketing coder's targets (``core/bbox.BucketingBBoxCoder``,
scale 3) give the bucket BCE (neighbours ignored) over ``num_pos * 4 *
7`` and the offsets' smooth L1 (beta 1/9) over ``num_pos * 4 * 2``, both
weighted 1.5; ``num_pos`` is summed over the ranks.

``get_bboxes`` (``:195-232``): the top ``nms_pre`` cells of each level by
their best class (ties by index), the bucketing decode, the scores times
its confidence, then ``batched_nms`` of the top 2048 pairs. Like tpudet's,
it takes no ``img_shape`` and has no raw (``with_nms=False``) path.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...core.anchors import AnchorGenerator
from ...core.assigners import NEGATIVE, approx_max_iou_assign_batch
from ...core.bbox import BucketingBBoxCoder
from ...core.nms import batched_nms
from ...parallel.mesh import global_sum
from ...registry import HEADS
from .. import losses as L
from .atss_head import (PRIOR_BIAS, flat, head_conv, matched_boxes,
                        no_dtype, num_gts, topk_levels)


class SquareAnchors:
    """Per-level square anchors and all levels' squares with their approx
    anchors, (A, 4) and (A, K, 4), on the maps' device (cached per sizes
    and device)."""

    def __init__(self, square: AnchorGenerator, approx: AnchorGenerator):
        self.square, self.approx = square, approx
        self._grids: Dict = {}

    def __call__(self, cls_scores):
        sizes = tuple(tuple(c.shape[1:3]) for c in cls_scores)
        dev = cls_scores[0].device
        key = (sizes, dev)
        if key not in self._grids:
            levels = self.square.grid_anchors(sizes)
            squares = np.concatenate(levels)
            approx = np.concatenate(self.approx.grid_anchors(sizes))
            self._grids[key] = (
                [torch.from_numpy(a).to(dev) for a in levels],
                torch.from_numpy(squares).to(dev),
                torch.from_numpy(approx.reshape(len(squares), -1, 4)).to(dev))
        return self._grids[key]


@HEADS.register_module()
class SABLRetinaHead(nn.Module):
    """The keyword arguments are tpudet's fields
    (``sabl_retina_head.py:32-50``) with its defaults."""

    def __init__(self, num_classes: int, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 strides: Sequence[int] = (8, 16, 32, 64, 128),
                 square_scale: int = 4,
                 approx_scales: Sequence[float] = (1.0, 2**(1 / 3),
                                                   2**(2 / 3)),
                 approx_ratios: Sequence[float] = (0.5, 1.0, 2.0),
                 num_buckets: int = 14, scale_factor: float = 3.0,
                 pos_iou_thr: float = 0.5, neg_iou_thr: float = 0.4,
                 focal_gamma: float = 2.0, focal_alpha: float = 0.25,
                 loss_bbox_cls_weight: float = 1.5,
                 loss_bbox_reg_weight: float = 1.5, dtype=None):
        super().__init__()
        no_dtype('SABLRetinaHead', dtype)
        self.num_classes = num_classes
        self.strides = tuple(strides)
        self.pos_iou_thr = pos_iou_thr
        self.neg_iou_thr = neg_iou_thr
        self.focal_gamma = focal_gamma
        self.focal_alpha = focal_alpha
        self.loss_bbox_cls_weight = loss_bbox_cls_weight
        self.loss_bbox_reg_weight = loss_bbox_reg_weight
        self.bbox_coder = BucketingBBoxCoder(num_buckets, scale_factor)
        self.side_num = self.bbox_coder.side_num
        self.anchors = SquareAnchors(
            AnchorGenerator(strides=list(self.strides), ratios=[1.0],
                            scales=[square_scale]),
            AnchorGenerator(strides=list(self.strides),
                            ratios=list(approx_ratios),
                            scales=[square_scale * s for s in approx_scales]))
        self.stacked_convs = stacked_convs
        for branch in ('cls', 'reg'):
            cin = in_channels
            for i in range(stacked_convs):
                self.add_module(f'{branch}_conv{i}', head_conv(cin,
                                                               feat_channels))
                cin = feat_channels
        self.retina_cls = head_conv(cin, num_classes, bias_init=PRIOR_BIAS)
        self.retina_bbox_cls = head_conv(cin, 4 * self.side_num)
        self.retina_bbox_reg = head_conv(cin, 4 * self.side_num)

    def forward(self, feats):
        """NCHW features -> per-level (B, H, W, C) class logits, (B, H, W,
        4S) bucket logits and (B, H, W, 4S) bucket offsets."""
        cls_out, bcls_out, breg_out = [], [], []
        for feat in feats:
            c = r = feat
            for i in range(self.stacked_convs):
                c = F.relu(getattr(self, f'cls_conv{i}')(c))
                r = F.relu(getattr(self, f'reg_conv{i}')(r))
            cls_out.append(self.retina_cls(c).permute(0, 2, 3, 1))
            bcls_out.append(self.retina_bbox_cls(r).permute(0, 2, 3, 1))
            breg_out.append(self.retina_bbox_reg(r).permute(0, 2, 3, 1))
        return tuple(cls_out), tuple(bcls_out), tuple(breg_out)

    def loss(self, preds, gt_bboxes, gt_labels, gt_valid
             ) -> Dict[str, torch.Tensor]:
        cls_scores, bucket_cls, bucket_reg = preds
        _, squares, approx = self.anchors(cls_scores)
        b, nc, s = cls_scores[0].shape[0], self.num_classes, self.side_num
        cls_flat = flat([c.float() for c in cls_scores], b, nc)
        bcls_flat = flat([c.float() for c in bucket_cls], b, 4 * s)
        breg_flat = flat([c.float() for c in bucket_reg], b, 4 * s)
        gt_bboxes = gt_bboxes.float()
        assigned = approx_max_iou_assign_batch(
            approx, gt_bboxes, gt_valid, self.pos_iou_thr, self.neg_iou_thr,
            match_low_quality=True)
        pos = assigned >= 0
        neg = assigned == NEGATIVE
        num_pos = torch.clamp_min(global_sum(pos.float().sum()), 1.0)
        gt_idx = assigned.clamp_min(0)
        labels = torch.gather(gt_labels.long(), 1, gt_idx)
        onehot = L.one_hot(labels, nc, torch.float32) * pos[..., None]
        loss_cls = L.sigmoid_focal_loss(
            cls_flat, onehot, gamma=self.focal_gamma, alpha=self.focal_alpha,
            weight=(pos | neg)[..., None].float(), avg_factor=num_pos)
        sq = squares[None].expand(b, -1, -1)
        matched = torch.where(pos[..., None],
                              matched_boxes(gt_bboxes, gt_idx), sq)
        labels_t, cls_w, offsets_t, off_w = self.bbox_coder.encode(sq,
                                                                   matched)
        pshape = pos[..., None, None].float()
        loss_bucket_cls = L.bce_loss(
            bcls_flat.reshape(labels_t.shape), labels_t,
            weight=cls_w * pshape, avg_factor=num_pos * 4 * s,
            loss_weight=self.loss_bbox_cls_weight)
        loss_bucket_reg = L.smooth_l1_loss(
            breg_flat.reshape(offsets_t.shape), offsets_t, beta=1.0 / 9.0,
            weight=off_w * pshape, avg_factor=num_pos * 4 * 2,
            loss_weight=self.loss_bbox_reg_weight)
        return dict(loss_cls=loss_cls, loss_bbox_cls=loss_bucket_cls,
                    loss_bbox_reg=loss_bucket_reg, num_gts=num_gts(gt_valid))

    def get_bboxes(self, preds, scale_factors=None, score_thr: float = 0.05,
                   iou_thr: float = 0.5, max_per_img: int = 100,
                   nms_pre: int = 1000, **kwargs):
        cls_scores, bucket_cls, bucket_reg = preds
        levels, _, _ = self.anchors(cls_scores)
        b, nc, s = cls_scores[0].shape[0], self.num_classes, self.side_num
        boxes_all, scores_all = [], []
        for cls, bc, br, squares in zip(cls_scores, bucket_cls, bucket_reg,
                                        levels):
            scores = torch.sigmoid(cls.reshape(b, -1, nc).float())
            bc = bc.reshape(b, -1, 4 * s).float()
            br = br.reshape(b, -1, 4 * s).float()
            k = min(nms_pre, scores.shape[1])
            if 0 < k < scores.shape[1]:
                scores, bc, br, sel = topk_levels(scores, k, bc, br, squares)
            else:
                sel = squares[None].expand(b, -1, -1)
            boxes, conf = self.bbox_coder.decode(sel, (bc, br))
            boxes_all.append(boxes)
            scores_all.append(scores * conf[..., None])
        bbox = torch.cat(boxes_all, dim=1)
        scores = torch.cat(scores_all, dim=1)
        if scale_factors is not None:
            bbox = bbox / torch.as_tensor(scale_factors, dtype=bbox.dtype,
                                          device=bbox.device)[:, None, :]
        return batched_nms(bbox, scores, score_thr, iou_thr, max_per_img,
                           nms_pre=2048)
