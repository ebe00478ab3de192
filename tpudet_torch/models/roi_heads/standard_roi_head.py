"""The standard two-stage RoI head: port of
``tpudet/models/roi_heads/standard_roi_head.py`` (``StandardRoIHead``
with the ``'single'`` extractor, ``'random'`` negatives and the ``'l1'``
and ``'smooth_l1'`` box losses).

- training: the proposals and the padded gts appended to them (mmdet's
  ``add_gt_as_proposals``) are MaxIoU-assigned to the gts, then 512 rois
  an image are sampled, at most 25 % positive, by a fixed priority, numpy
  ``RandomState(1).rand(n_rois)`` (the positives, then the negatives, of
  lowest priority, ties by index), and gathered sampled-first into a
  fixed (B, 512) slot table;
- the RoI features come from the port's multilevel RoIAlign, each roi
  pooled at its own FPN level (``ops/roi_align.py``);
- losses: softmax cross-entropy over the sampled rois, the class-specific
  L1 (or smooth L1) of the deltas over the positives, both over the
  batch's sampled count;
- testing: softmax scores without the background column, per-class
  decode clipped per image, the top 2048 (roi, class) pairs over
  ``score_thr`` and one class-offset NMS an image.

``roi_extractor='generic'`` (GRoIE), ``neg_sampling='iou_balanced'`` and
``loss_bbox_type='balanced_l1'`` (Libra R-CNN) and the
``Shared4Conv1FCBBoxHead`` with GN/WS are not ported: they raise.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...core.assigners import max_iou_assign_batch, priority_rank
from ...core.bbox import DeltaXYWHBBoxCoder
from ...core.nms import (NEG_INF, NMSResult, _class_offsets, _gather_rows,
                         nms_padded, topk_scores)
from ...ops.roi_align import batched_multilevel_roi_align
from ...registry import HEADS
from .. import losses as L
from ..dense_heads.rpn_head import fixed_priority
from .bbox_head import Shared2FCBBoxHead

ZOO = 'comes with ROADMAP.md\'s "rest of the zoo" item'


def _refuse(roi_extractor, neg_sampling, loss_bbox_type, bbox_head_type,
            norm, conv_ws):
    if roi_extractor != 'single':
        raise NotImplementedError(
            f'StandardRoIHead(roi_extractor={roi_extractor!r}) (GRoIE\'s '
            f'generic extractor) is not ported; it {ZOO}')
    if neg_sampling != 'random':
        raise NotImplementedError(
            f'StandardRoIHead(neg_sampling={neg_sampling!r}) (Libra '
            f'R-CNN\'s IoU-balanced sampling) is not ported; it {ZOO}')
    if loss_bbox_type == 'balanced_l1':
        raise NotImplementedError(
            'StandardRoIHead(loss_bbox_type=\'balanced_l1\') (Libra '
            f'R-CNN) is not ported; it {ZOO}')
    if bbox_head_type != 'Shared2FCBBoxHead' or norm is not None or conv_ws:
        raise NotImplementedError(
            f'StandardRoIHead(bbox_head_type={bbox_head_type!r}, '
            f'norm={norm!r}, conv_ws={conv_ws!r}): only Shared2FCBBoxHead '
            f'without norm is ported; Shared4Conv1FCBBoxHead with GN/WS '
            f'{ZOO}')


@HEADS.register_module()
class StandardRoIHead(nn.Module):
    """The keyword arguments are tpudet's fields
    (``standard_roi_head.py:31-59``) with its defaults."""

    def __init__(self, num_classes: int, in_channels: int = 256,
                 featmap_strides: Sequence[int] = (4, 8, 16, 32),
                 roi_size: int = 7, num_samples: int = 512,
                 pos_fraction: float = 0.25, pos_iou_thr: float = 0.5,
                 neg_iou_thr: float = 0.5, min_pos_iou: float = 0.5,
                 target_stds: Sequence[float] = (0.1, 0.1, 0.2, 0.2),
                 bbox_head_type: str = 'Shared2FCBBoxHead', norm=None,
                 gn_groups: int = 32, conv_ws: bool = False,
                 neg_sampling: str = 'random', neg_num_bins: int = 3,
                 loss_bbox_type: str = 'l1', roi_extractor: str = 'single',
                 dtype=None):
        super().__init__()
        _refuse(roi_extractor, neg_sampling, loss_bbox_type, bbox_head_type,
                norm, conv_ws)
        if dtype is not None:
            raise ValueError(f'StandardRoIHead: dtype={dtype!r} is not a '
                             f'module setting in the port; see '
                             f'TwoStageDetector.set_dtype')
        self.num_classes = num_classes
        self.featmap_strides = tuple(featmap_strides)
        self.roi_size = roi_size
        self.num_samples = num_samples
        self.pos_fraction = pos_fraction
        self.pos_iou_thr = pos_iou_thr
        self.neg_iou_thr = neg_iou_thr
        self.min_pos_iou = min_pos_iou
        self.loss_bbox_type = loss_bbox_type
        self.bbox_coder = DeltaXYWHBBoxCoder(target_stds=target_stds)
        self.bbox_head = Shared2FCBBoxHead(
            num_classes=num_classes, in_channels=in_channels,
            roi_feat_size=roi_size, target_stds=target_stds)

    def extract(self, feats, rois, roi_valid, out_size=None):
        """Multilevel RoIAlign of a batch: ``feats`` NCHW per level,
        ``rois`` (B, P, 4) -> (B, P, s, s, C), s = ``out_size`` or
        ``roi_size``."""
        feats = [f.permute(0, 2, 3, 1)
                 for f in feats[:len(self.featmap_strides)]]
        return batched_multilevel_roi_align(
            feats, rois, roi_valid, out_size=out_size or self.roi_size,
            strides=self.featmap_strides)

    def forward(self, feats, rois, roi_valid):
        """Pool and run the bbox head: (B, P, C + 1) logits, (B, P, 4C)
        deltas."""
        return self.bbox_head(self.extract(feats, rois, roi_valid))

    def sample_rois(self, proposals, prop_valid, gt_bboxes, gt_labels,
                    gt_valid, num_samples: Optional[int] = None,
                    iou_thr=None, return_is_gt: bool = False):
        """Assign and sample a fixed-size roi batch
        (``standard_roi_head.py:117-220``). ``iou_thr`` overrides the
        pos/neg/min thresholds together (DynamicRCNN's hook).

        Returns:
            ``(rois (B, S, 4), sampled (B, S), labels (B, S) with
            background == num_classes, reg targets (B, S, 4), pos (B,
            S))``, and with ``return_is_gt`` the slots that came from the
            appended gts last.
        """
        s = num_samples or self.num_samples
        pos_thr = self.pos_iou_thr if iou_thr is None else iou_thr
        neg_thr = self.neg_iou_thr if iou_thr is None else iou_thr
        min_thr = self.min_pos_iou if iou_thr is None else iou_thr
        gt_bboxes = gt_bboxes.float()
        rois = torch.cat([proposals.float(), gt_bboxes], dim=1)
        valid = torch.cat([prop_valid, gt_valid], dim=1)
        assigned = max_iou_assign_batch(rois, gt_bboxes, gt_valid, pos_thr,
                                        neg_thr, min_thr, True)
        assigned = torch.where(valid, assigned, -2)  # invalid rois: ignore
        pos = assigned >= 0
        neg = assigned == -1

        n_rois = rois.shape[1]
        priority = fixed_priority(n_rois, 1, rois.device)
        pos_keep = pos & (priority_rank(pos, priority) <
                          int(s * self.pos_fraction))
        n_pos = pos_keep.sum(dim=1, keepdim=True)
        neg_keep = neg & (priority_rank(neg, priority) < s - n_pos)
        sampled = pos_keep | neg_keep

        # the slot table, sampled first: a stable sort of the integers
        # (not sampled) keeps each group in index order
        order = torch.argsort((~sampled).to(torch.int32), dim=1,
                              stable=True)[:, :s]
        out_rois = _gather_rows(rois, order)
        out_sampled = torch.gather(sampled, 1, order)
        out_pos = torch.gather(pos_keep, 1, order)
        gt_idx = torch.gather(assigned, 1, order).clamp_min(0)
        labels = torch.where(out_pos, torch.gather(gt_labels.long(), 1,
                                                   gt_idx),
                             self.num_classes)
        matched = torch.where(out_pos[..., None],
                              _gather_rows(gt_bboxes, gt_idx), out_rois)
        targets = self.bbox_coder.encode(out_rois, matched)
        out = (out_rois, out_sampled, labels, targets, out_pos)
        if return_is_gt:
            # the slots from the appended gt block (the reference's
            # SamplingResult.pos_is_gt, read by cascade's refine_bboxes)
            src_is_gt = torch.arange(n_rois, device=rois.device) >= \
                proposals.shape[1]
            out += (src_is_gt[order],)
        return out

    def loss(self, cls_logits, deltas, labels, targets, pos, sampled,
             rois=None) -> Dict[str, torch.Tensor]:
        """Softmax cross-entropy and the class-specific L1 (or smooth L1,
        beta 1) of the deltas, in fp32 (``standard_roi_head.py:222-255``).
        """
        num_total = torch.clamp_min(sampled.float().sum(), 1.0)
        logp = F.log_softmax(cls_logits.float(), dim=-1)
        ce = -torch.gather(logp, -1, labels[..., None])[..., 0]
        loss_cls = (ce * sampled).sum() / num_total

        b, s = labels.shape
        if deltas.shape[-1] == 4:
            reg = deltas.float()
        else:
            reg = deltas.reshape(b, s, self.num_classes, 4).float()
            cls_idx = labels.clamp(0, self.num_classes - 1)
            reg = torch.gather(reg, 2, cls_idx[..., None, None].expand(
                b, s, 1, 4))[:, :, 0]
        weight = pos[..., None].float()
        if self.loss_bbox_type == 'smooth_l1':
            # cascade's stages regress with SmoothL1(beta=1)
            loss_bbox = L.smooth_l1_loss(reg, targets, beta=1.0,
                                         weight=weight, avg_factor=num_total)
        else:
            loss_bbox = L.l1_loss(reg, targets, weight=weight,
                                  avg_factor=num_total)
        return dict(loss_cls=loss_cls, loss_bbox=loss_bbox)

    def get_bboxes(self, rois, roi_valid, cls_logits, deltas,
                   scale_factors=None, score_thr: float = 0.05,
                   iou_thr: float = 0.5, max_per_img: int = 100,
                   img_shape=None, **kwargs) -> NMSResult:
        """Decode and class-aware NMS, in fp32
        (``standard_roi_head.py:257-317``).

        Args:
            rois: (B, P, 4) proposals; roi_valid: (B, P).
            scale_factors: optional (B, 4); boxes are divided back to the
                original images.
            img_shape: optional ``(h, w)``, numbers or per-image (B, 1)
                columns: each class's box is clipped to it.

        Returns:
            NMSResult with (B, max_per_img, ...) padded detections.
        """
        scores = F.softmax(cls_logits.float(), dim=-1)[..., :-1]
        scores = scores * roi_valid[..., None]
        b, p = rois.shape[:2]
        c = self.num_classes
        rois = rois.float()

        def bound(v, extra_dims):
            # per-image (B, 1) bounds broadcast over the (B, P[, C])
            # coordinate planes; numbers pass through
            if torch.is_tensor(v) and v.dim() >= 1:
                return v.reshape((-1,) + (1,) * extra_dims)
            return v

        if deltas.shape[-1] == 4:
            shp = None if img_shape is None else (
                bound(img_shape[0], 1), bound(img_shape[1], 1))
            boxes = self.bbox_coder.decode(rois, deltas.float(),
                                           max_shape=shp)
            boxes_pc = boxes[:, :, None].expand(b, p, c, 4)
        else:
            shp = None if img_shape is None else (
                bound(img_shape[0], 2), bound(img_shape[1], 2))
            boxes_pc = self.bbox_coder.decode(
                rois[:, :, None], deltas.reshape(b, p, c, 4).float(),
                max_shape=shp)
        if scale_factors is not None:
            scale_factors = torch.as_tensor(scale_factors,
                                            dtype=boxes_pc.dtype,
                                            device=boxes_pc.device)
            boxes_pc = boxes_pc / scale_factors[:, None, None, :]
        # every (roi, class) pair is a candidate with its own box
        flat_boxes = boxes_pc.reshape(b, p * c, 4)
        flat_scores = scores.reshape(b, p * c)
        labels = torch.arange(c, device=rois.device).repeat(p)
        masked = torch.where(flat_scores > score_thr, flat_scores,
                             torch.full_like(flat_scores, NEG_INF))
        top_s, top_i = topk_scores(masked, min(2048, p * c))
        top_valid = top_s > NEG_INF / 2
        cand = _gather_rows(flat_boxes, top_i)
        lab = labels[top_i]
        offsets, _ = _class_offsets(cand, top_valid, lab)
        keep_idx, keep_valid = nms_padded(cand + offsets[..., None], top_s,
                                          iou_thr, max_per_img, top_valid)
        return NMSResult(
            torch.where(keep_valid[..., None], _gather_rows(cand, keep_idx),
                        0.),
            torch.where(keep_valid, torch.gather(top_s, 1, keep_idx), 0.),
            torch.where(keep_valid, torch.gather(lab, 1, keep_idx), -1),
            keep_valid)
