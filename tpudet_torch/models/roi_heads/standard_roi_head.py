"""The standard two-stage RoI head: port of
``tpudet/models/roi_heads/standard_roi_head.py`` (``StandardRoIHead``).

- training: the proposals and the padded gts appended to them (mmdet's
  ``add_gt_as_proposals``) are MaxIoU-assigned to the gts, then 512 rois
  an image are sampled, at most 25 % positive, by a fixed priority, numpy
  ``RandomState(1).rand(n_rois)`` (the positives, then the negatives, of
  lowest priority, ties by index), and gathered sampled-first into a
  fixed (B, 512) slot table. Libra R-CNN's ``neg_sampling=
  'iou_balanced'`` splits the negatives by their max IoU into
  ``neg_num_bins`` bins over ``[0, neg_iou_thr)``, takes an equal share of
  each bin, fills the shortfall from the remaining negatives and trims
  the overshoot, every step by the same priority;
- the RoI features come from the port's multilevel RoIAlign, each roi
  pooled at its own FPN level (``ops/roi_align.py``), or with
  ``roi_extractor='generic'`` (GRoIE) the sum of its RoIAlign over every
  level, invalid rois 0;
- losses: softmax cross-entropy over the sampled rois, the class-specific
  L1 (or smooth L1, or Libra's balanced L1) of the deltas over the
  positives, both over the batch's sampled count;
- testing: softmax scores without the background column, per-class
  decode clipped per image, the top 2048 (roi, class) pairs over
  ``score_thr`` and one class-offset NMS an image.

The bbox head is ``Shared2FCBBoxHead``, or ``Shared4Conv1FCBBoxHead``
with ``bbox_head_type`` (``norm``, ``gn_groups``, ``conv_ws``: the GN and
GN+WS configs); any other type builds the 2-FC head, as tpudet's ``setup``
does. An option value without a branch (a typo, which tpudet would take
as the default) raises ``ValueError``.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...core.assigners import max_iou_assign_batch, priority_rank
from ...core.bbox import DeltaXYWHBBoxCoder, bbox_overlaps
from ...core.nms import (NEG_INF, NMSResult, _class_offsets, _gather_rows,
                         nms_padded, topk_scores)
from ...parallel.mesh import global_sum
from ...ops.roi_align import (batched_generic_roi_align,
                               batched_multilevel_roi_align)
from ...registry import HEADS
from .. import losses as L
from ..dense_heads.rpn_head import fixed_priority
from .bbox_head import Shared2FCBBoxHead, Shared4Conv1FCBBoxHead

OPTIONS = {'roi_extractor': ('single', 'generic'),
           'neg_sampling': ('random', 'iou_balanced'),
           'loss_bbox_type': ('l1', 'smooth_l1', 'balanced_l1')}


def _check_options(**given):
    for name, value in given.items():
        if value not in OPTIONS[name]:
            raise ValueError(f'StandardRoIHead({name}={value!r}): the port '
                             f'has {", ".join(OPTIONS[name])}')


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
        _check_options(roi_extractor=roi_extractor,
                       neg_sampling=neg_sampling,
                       loss_bbox_type=loss_bbox_type)
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
        self.roi_extractor = roi_extractor
        self.neg_sampling = neg_sampling
        self.neg_num_bins = neg_num_bins
        self.loss_bbox_type = loss_bbox_type
        self.bbox_coder = DeltaXYWHBBoxCoder(target_stds=target_stds)
        if bbox_head_type == 'Shared4Conv1FCBBoxHead':
            self.bbox_head = Shared4Conv1FCBBoxHead(
                num_classes=num_classes, in_channels=in_channels,
                roi_feat_size=roi_size, target_stds=target_stds, norm=norm,
                gn_groups=gn_groups, conv_ws=conv_ws)
        else:
            self.bbox_head = Shared2FCBBoxHead(
                num_classes=num_classes, in_channels=in_channels,
                roi_feat_size=roi_size, target_stds=target_stds)

    def extract(self, feats, rois, roi_valid, out_size=None):
        """Multilevel RoIAlign of a batch: ``feats`` NCHW per level,
        ``rois`` (B, P, 4) -> (B, P, s, s, C), s = ``out_size`` or
        ``roi_size``; each roi from its level, or with the generic
        extractor the sum over every level (``standard_roi_head.py:
        79-109``; tpudet's comment names a ContextBlock after the sum,
        which its code does not run, nor does the port)."""
        feats = [f.permute(0, 2, 3, 1)
                 for f in feats[:len(self.featmap_strides)]]
        if self.roi_extractor == 'generic':
            return batched_generic_roi_align(
                feats, rois, roi_valid, out_size=out_size or self.roi_size,
                strides=self.featmap_strides)
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
        if self.neg_sampling == 'iou_balanced':
            neg_keep = self._iou_balanced_negatives(
                rois, gt_bboxes, gt_valid, neg, priority, s - n_pos,
                neg_thr)
        else:
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

    def _iou_balanced_negatives(self, rois, gt_bboxes, gt_valid, neg,
                                priority, want, neg_thr):
        """Libra R-CNN's IoU-balanced negatives (``standard_roi_head.py:
        153-190``): ``neg`` (B, R) split by each roi's max IoU with a
        valid gt into ``neg_num_bins`` bins of ``[0, neg_thr)`` (the last
        open above), ``want // bins + 1`` of each bin, the shortfall under
        ``want`` (B, 1) filled from the other negatives, then the set cut
        to ``want``, every step by ``priority`` (ties by index)."""
        ious = bbox_overlaps(rois, gt_bboxes)  # (B, R, G)
        max_iou = torch.where(gt_valid[:, None, :], ious,
                              ious.new_zeros(())).amax(dim=2)
        bins = self.neg_num_bins
        bin_w = float(neg_thr) / bins if float(neg_thr) > 0 else 1.0
        bin_id = torch.clamp((max_iou / bin_w).to(torch.int32), 0,
                             bins - 1)
        per_bin = want // bins + 1
        keep = torch.zeros_like(neg)
        for i in range(bins):
            in_bin = neg & (bin_id == i)
            keep = keep | (in_bin & (priority_rank(in_bin, priority) <
                                     per_bin))
        deficit = want - keep.sum(dim=1, keepdim=True)
        rest = neg & ~keep
        keep = keep | (rest & (priority_rank(rest, priority) < deficit))
        return keep & (priority_rank(keep, priority) < want)

    def loss(self, cls_logits, deltas, labels, targets, pos, sampled,
             rois=None) -> Dict[str, torch.Tensor]:
        """Softmax cross-entropy and the class-specific L1 (or smooth L1,
        beta 1, or balanced L1) of the deltas, in fp32
        (``standard_roi_head.py:222-255``)."""
        num_total = torch.clamp_min(global_sum(sampled.float().sum()), 1.0)
        logp = F.log_softmax(cls_logits.float(), dim=-1)
        ce = -torch.gather(logp, -1, labels[..., None])[..., 0]
        loss_cls = (ce * sampled).sum() / num_total

        reg = class_deltas(deltas, labels, self.num_classes)
        weight = pos[..., None].float()
        if self.loss_bbox_type == 'balanced_l1':
            loss_bbox = L.balanced_l1_loss(reg, targets, weight=weight,
                                           avg_factor=num_total)
        elif self.loss_bbox_type == 'smooth_l1':
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
            boxes_pc = boxes_pc / torch.as_tensor(
                scale_factors, dtype=boxes_pc.dtype,
                device=boxes_pc.device)[:, None, None, :]
        return pair_nms(boxes_pc, scores, score_thr, iou_thr, max_per_img)


def class_deltas(deltas, labels, num_classes: int):
    """Each slot's deltas for its label (B, S, 4), fp32: the 4-wide
    deltas as they are, or the label's 4 of class-specific (B, S, 4C) ones
    (the background's clipped to the last class; ``standard_roi_head.py:
    230-238``)."""
    if deltas.shape[-1] == 4:
        return deltas.float()
    b, s = labels.shape
    reg = deltas.reshape(b, s, num_classes, 4).float()
    cls_idx = labels.clamp(0, num_classes - 1)
    return torch.gather(reg, 2, cls_idx[..., None, None].expand(
        b, s, 1, 4))[:, :, 0]


def pair_nms(boxes_pc, scores, score_thr: float, iou_thr: float,
             max_per_img: int) -> NMSResult:
    """Every (roi, class) pair of ``boxes_pc`` (B, P, C, 4) and ``scores``
    (B, P, C) over ``score_thr`` is a candidate with its own box: the top
    2048 by score (ties by index) go through one class-offset NMS an image
    (``standard_roi_head.py:295-317``, ``cascade_roi_head.py:178-204``)."""
    b, p, c = scores.shape
    flat_boxes = boxes_pc.reshape(b, p * c, 4)
    flat_scores = scores.reshape(b, p * c)
    labels = torch.arange(c, device=scores.device).repeat(p)
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
        torch.where(keep_valid[..., None], _gather_rows(cand, keep_idx), 0.),
        torch.where(keep_valid, torch.gather(top_s, 1, keep_idx), 0.),
        torch.where(keep_valid, torch.gather(lab, 1, keep_idx), -1),
        keep_valid)
