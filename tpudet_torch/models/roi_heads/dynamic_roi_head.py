"""Dynamic R-CNN: port of ``tpudet/models/roi_heads/dynamic_roi_head.py``
(``DynamicRoIHead``, ``DynamicRCNN``).

Training adapts two settings to the batch, as tpudet does (the current
batch's statistics each step, not mmdet's 100-iteration window):

- ``sample_rois`` (``:35-52``): for each image, each valid gt's 75th
  highest IoU with the proposals, averaged over its valid gts; the mean
  over the images, floored at 0.4, is the pos / neg / min IoU threshold
  of ``StandardRoIHead.sample_rois`` (a 0-d tensor);
- ``loss`` (``:58-87``): the regression's smooth-L1 beta is the
  ``10 B``-th smallest mean |error| of (dx, dy) over the positives of the
  ``B`` images (infinite elsewhere), clipped to [1e-3, 1.0] and without
  gradient; the metric ``dynamic_beta`` (a rank's share of it, as every
  entry of the loss dict: the train step's sum over the ranks is beta).

Under a process group both statistics are the whole batch's, as in
tpudet's SPMD batch: the threshold's mean runs over every rank's images
(``global_sum`` / ``global_count``) and the k-th smallest over every
rank's slots (``all_gather``), with ``B`` every rank's images.

Inference is Faster R-CNN's, module for module.
"""
from __future__ import annotations

from typing import Dict

import torch

from ...core.bbox import bbox_overlaps
from ...parallel.mesh import (all_gather, global_count, global_sum,
                              process_count)
from ...registry import DETECTORS, HEADS
from ..detectors.two_stage import TwoStageDetector
from .standard_roi_head import StandardRoIHead, class_deltas


@HEADS.register_module()
class DynamicRoIHead(StandardRoIHead):
    """``StandardRoIHead``'s keyword arguments and tpudet's fields
    (``dynamic_roi_head.py:120-123``)."""

    def __init__(self, num_classes: int, in_channels: int = 256,
                 initial_iou: float = 0.4, iou_topk: int = 75,
                 initial_beta: float = 1.0, beta_topk: int = 10, **kwargs):
        super().__init__(num_classes, in_channels, **kwargs)
        self.initial_iou = initial_iou
        self.iou_topk = iou_topk
        self.initial_beta = initial_beta
        self.beta_topk = beta_topk

    def iou_threshold(self, proposals, prop_valid, gt_bboxes, gt_valid):
        """The batch's IoU threshold, a 0-d fp32 tensor."""
        ious = bbox_overlaps(proposals.float(), gt_bboxes.float())  # B P G
        ious = torch.where(prop_valid[:, :, None] & gt_valid[:, None, :],
                           ious, ious.new_zeros(()))
        k = min(self.iou_topk, proposals.shape[1])
        per_gt = torch.topk(ious.transpose(1, 2), k, dim=2).values[..., -1]
        cnt = torch.clamp_min(gt_valid.float().sum(dim=1), 1.0)
        per_img = torch.where(gt_valid, per_gt, per_gt.new_zeros(())
                              ).sum(dim=1) / cnt
        thr = global_sum(per_img.sum()) / global_count(per_img.shape[0],
                                                       per_img.device)
        return torch.clamp_min(thr, self.initial_iou)

    def sample_rois(self, proposals, prop_valid, gt_bboxes, gt_labels,
                    gt_valid, **kwargs):
        thr = self.iou_threshold(proposals, prop_valid, gt_bboxes, gt_valid)
        return super().sample_rois(proposals, prop_valid, gt_bboxes,
                                   gt_labels, gt_valid, iou_thr=thr,
                                   **kwargs)

    def loss(self, cls_logits, deltas, labels, targets, pos, sampled,
             rois=None) -> Dict:
        out = super().loss(cls_logits, deltas, labels, targets, pos, sampled)
        s = labels.shape[1]
        reg = class_deltas(deltas, labels, self.num_classes)
        err = (reg[..., :2] - targets[..., :2]).abs().mean(dim=-1)
        err = torch.where(pos, err, torch.full_like(err, float('inf')))
        errs = all_gather(err).reshape(-1)
        b_all = errs.numel() // s
        k = min(self.beta_topk * b_all, s * b_all)
        beta = torch.clamp(torch.kthvalue(errs, k).values, 1e-3,
                           self.initial_beta)
        num_total = torch.clamp_min(global_sum(sampled.float().sum()), 1.0)
        diff = (reg - targets).abs()
        sl1 = torch.where(diff < beta, 0.5 * diff * diff / beta,
                          diff - 0.5 * beta)
        out['loss_bbox'] = (sl1 * pos[..., None].float()).sum() / num_total
        # every entry of a loss dict is a rank's share, which the train
        # step sums over the ranks: the metric reads beta there too
        out['dynamic_beta'] = beta / process_count()
        return out


@DETECTORS.register_module()
class DynamicRCNN(TwoStageDetector):
    """reference configs/dynamic_rcnn."""
