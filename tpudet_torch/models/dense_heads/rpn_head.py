"""RPN head: port of ``tpudet/models/dense_heads/rpn_head.py``.

A shared 3x3 conv with ReLU, then 1x1 objectness (A outputs) and 1x1
deltas (4A) on every FPN level, A = 3 anchors a cell; every conv draws
N(0, 0.01^2) with a zero bias. Pred maps leave the head in tpudet's
layout, (B, H, W, A*attrib) with the anchor axis fastest.

``loss`` assigns every anchor by the dense MaxIoU assigner and samples
256 anchors an image (at most half positive) by a fixed priority, numpy
``RandomState(0).rand(n_anchors)``, in place of mmdet's random sampler:
the positives, then the negatives, of lowest priority (ties by index)
are kept. Objectness takes the BCE over the sampled anchors, the deltas
the L1 over the kept positives, both over the batch's sampled count.

``get_proposals`` takes the top ``nms_pre`` anchors of each level by
objectness (ties by index), decodes them clipped to ``img_shape``, drops
boxes under ``min_bbox_size`` when it is above 0, and runs one NMS of
the whole batch with each level offset by ``level * (max coord + 1)``,
the max over the batch's kept boxes, as tpudet's arithmetic has it.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...core.anchors import AnchorGenerator
from ...core.assigners import NEGATIVE, max_iou_assign_batch, priority_rank
from ...core.bbox import DeltaXYWHBBoxCoder
from ...core.nms import _gather_rows, nms_padded, topk_scores
from ...registry import HEADS
from .. import losses as L
from ..layers import Conv


def fixed_priority(n: int, seed: int, device) -> torch.Tensor:
    """tpudet's sample priority: numpy ``RandomState(seed).rand(n)`` in
    fp32, on ``device``."""
    return torch.from_numpy(np.random.RandomState(seed).rand(n).astype(
        np.float32)).to(device)


@HEADS.register_module()
class RPNHead(nn.Module):
    """The keyword arguments are tpudet's fields (``rpn_head.py:27-38``)
    with its defaults."""

    def __init__(self, in_channels: int = 256, feat_channels: int = 256,
                 strides: Sequence[int] = (4, 8, 16, 32, 64),
                 anchor_scales: Sequence[float] = (8,),
                 anchor_ratios: Sequence[float] = (0.5, 1.0, 2.0),
                 pos_iou_thr: float = 0.7, neg_iou_thr: float = 0.3,
                 min_pos_iou: float = 0.3, num_samples: int = 256,
                 pos_fraction: float = 0.5, dtype=None):
        super().__init__()
        if dtype is not None:
            raise ValueError(f'RPNHead: dtype={dtype!r} is not a module '
                             f'setting in the port; see '
                             f'TwoStageDetector.set_dtype')
        self.strides = tuple(strides)
        self.pos_iou_thr = pos_iou_thr
        self.neg_iou_thr = neg_iou_thr
        self.min_pos_iou = min_pos_iou
        self.num_samples = num_samples
        self.pos_fraction = pos_fraction
        self.num_anchors = len(anchor_scales) * len(anchor_ratios)
        self.anchor_generator = AnchorGenerator(
            strides=list(self.strides), ratios=list(anchor_ratios),
            scales=list(anchor_scales))
        self.bbox_coder = DeltaXYWHBBoxCoder()
        normal = ('normal', 0.01)
        self.rpn_conv = Conv(in_channels, feat_channels, 3, 1, 1,
                             kernel_init=normal)
        self.rpn_cls = Conv(feat_channels, self.num_anchors, 1,
                            kernel_init=normal)
        self.rpn_reg = Conv(feat_channels, self.num_anchors * 4, 1,
                            kernel_init=normal)
        self._cache: Dict = {}

    def forward(self, feats):
        """NCHW features -> (per-level (B, H, W, A) objectness logits,
        per-level (B, H, W, 4A) deltas)."""
        cls_out, reg_out = [], []
        for feat in feats:
            x = F.relu(self.rpn_conv(feat))
            cls_out.append(self.rpn_cls(x).permute(0, 2, 3, 1))
            reg_out.append(self.rpn_reg(x).permute(0, 2, 3, 1))
        return tuple(cls_out), tuple(reg_out)

    def _anchors(self, cls_scores):
        """Per-level anchors, all levels' anchors and the sample priority
        of the pred maps' sizes, on their device (cached)."""
        sizes = tuple(tuple(c.shape[1:3]) for c in cls_scores)
        dev = cls_scores[0].device
        key = (sizes, dev)
        if key not in self._cache:
            levels = self.anchor_generator.grid_anchors(sizes)
            flat = np.concatenate(levels)
            self._cache[key] = (
                [torch.from_numpy(a).to(dev) for a in levels],
                torch.from_numpy(flat).to(dev),
                fixed_priority(len(flat), 0, dev))
        return self._cache[key]

    def loss(self, preds, gt_bboxes, gt_labels, gt_valid
             ) -> Dict[str, torch.Tensor]:
        """BCE objectness and L1 deltas on the sampled anchors, in fp32
        (``tpudet/models/dense_heads/rpn_head.py:78-134``). ``gt_labels``
        is not read: RPN objectness is class-agnostic.

        Returns:
            dict with ``loss_rpn_cls`` and ``loss_rpn_bbox``.
        """
        cls_scores, bbox_preds = preds
        _, anchors, priority = self._anchors(cls_scores)
        b = cls_scores[0].shape[0]
        cls_flat = torch.cat([c.reshape(b, -1).float() for c in cls_scores],
                             dim=1)
        reg_flat = torch.cat([r.reshape(b, -1, 4).float()
                              for r in bbox_preds], dim=1)
        gt_bboxes = gt_bboxes.float()
        assigned = max_iou_assign_batch(anchors, gt_bboxes, gt_valid,
                                        self.pos_iou_thr, self.neg_iou_thr,
                                        self.min_pos_iou, True)
        pos = assigned >= 0
        neg = assigned == NEGATIVE
        max_pos = int(self.num_samples * self.pos_fraction)
        num_pos = pos.sum(dim=1, keepdim=True)
        pos_keep = pos & (priority_rank(pos, priority) <
                          torch.clamp_max(num_pos, max_pos))
        n_pos_kept = pos_keep.sum(dim=1, keepdim=True)
        neg_keep = neg & (priority_rank(neg, priority) <
                          self.num_samples - n_pos_kept)
        sampled = pos_keep | neg_keep
        num_total = torch.clamp_min(sampled.float().sum(), 1.0)

        loss_cls = L.bce_loss(cls_flat, pos_keep.float(),
                              weight=sampled.float(), avg_factor=num_total)
        gt_idx = assigned.clamp_min(0)
        matched = _gather_rows(gt_bboxes, gt_idx)
        matched = torch.where(pos_keep[..., None], matched, anchors[None])
        deltas = self.bbox_coder.encode(anchors[None], matched)
        loss_bbox = L.l1_loss(reg_flat, deltas,
                              weight=pos_keep[..., None].float(),
                              avg_factor=num_total)
        return dict(loss_rpn_cls=loss_cls, loss_rpn_bbox=loss_bbox)

    def get_proposals(self, preds, img_shape=None, nms_pre: int = 1000,
                      max_num: int = 1000, iou_thr: float = 0.7,
                      min_bbox_size: float = 0.):
        """Proposals of the batch, in fp32
        (``tpudet/models/dense_heads/rpn_head.py:136-189``).

        Returns:
            ``(proposals (B, max_num, 4), scores (B, max_num), valid (B,
            max_num))``, zero where not valid, in score order.
        """
        cls_scores, bbox_preds = preds
        levels, _, _ = self._anchors(cls_scores)
        b = cls_scores[0].shape[0]
        boxes_all, scores_all, level_all = [], [], []
        for lvl, anchors in enumerate(levels):
            scores = torch.sigmoid(cls_scores[lvl].reshape(b, -1).float())
            deltas = bbox_preds[lvl].reshape(b, -1, 4).float()
            k = min(nms_pre, scores.shape[1])
            if 0 < k < scores.shape[1]:
                scores, topk = topk_scores(scores, k)
                deltas = _gather_rows(deltas, topk)
                lvl_anchors = anchors[topk]
            else:
                lvl_anchors = anchors[None].expand(b, -1, -1)
            boxes_all.append(self.bbox_coder.decode(lvl_anchors, deltas,
                                                    max_shape=img_shape))
            scores_all.append(scores)
            level_all.append(torch.full(scores.shape, float(lvl),
                                        device=scores.device))
        boxes = torch.cat(boxes_all, dim=1)
        scores = torch.cat(scores_all, dim=1)
        lvls = torch.cat(level_all, dim=1)
        # the min-size filter runs only above 0 and keeps sides >= it, as
        # the reference (rpn_head.py:235-245); at 0 even zero-width boxes
        # stay in (IoU 0 with everything, they only take ranking slots)
        if min_bbox_size > 0:
            w = boxes[..., 2] - boxes[..., 0]
            h = boxes[..., 3] - boxes[..., 1]
            valid = (w >= min_bbox_size) & (h >= min_bbox_size)
        else:
            valid = torch.ones(boxes.shape[:-1], dtype=torch.bool,
                               device=boxes.device)
        # level-aware NMS by coordinate offsets: the max over the batch
        max_coord = torch.where(valid[..., None], boxes, 0.).max()
        offset_boxes = boxes + (lvls * (max_coord + 1.))[..., None]
        keep_idx, keep_valid = nms_padded(offset_boxes, scores, iou_thr,
                                          max_num, valid)
        props = torch.where(keep_valid[..., None],
                            _gather_rows(boxes, keep_idx), 0.)
        pscores = torch.where(keep_valid, torch.gather(scores, 1, keep_idx),
                              0.)
        return props, pscores, keep_valid
