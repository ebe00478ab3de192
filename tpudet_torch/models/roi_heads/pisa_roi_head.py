"""PISA's RoI head: port of ``tpudet/models/roi_heads/pisa_roi_head.py``
(``PISARoIHead``, ``PISAFasterRCNN``).

``loss`` (``:41-107``) on ``StandardRoIHead``'s sampled rois:

- ISR-P: the positives of the flattened batch, positives first and then
  by IoU descending (a stable ``argsort`` of ``where(pos, -iou, 2)``),
  capped at the first 512, get ``isr_weights_masks``' importance. A
  slot's IoU is that of its decoded prediction (no gradient) with its
  target box, the target ``decode(roi, target)``: the matched gt,
  recovered. Two slots are of one gt where their labels and images agree
  and their target boxes are bit-equal (``:80-81``); the coder's round
  trip is not exact, so two rois of one gt may decode an ulp apart and
  then rank as two gts, as in tpudet. The weights are renormalized to keep
  the positives' cross-entropy sum and carry no gradient;
- the cross-entropy so weighted over the sampled rois, the smooth L1 (beta
  1) of the class's deltas over the positives, and CARL: each positive's
  smooth-L1 sum times ``carl_weights`` of its class score (with its
  gradient), all over the sampled count.

Under a process group the statistics are the whole batch's: the rank set
over every rank's slots (``all_gather``, the image index of a slot counts
over every rank's images), ``max_l_num`` among them, the ratio's two sums,
and CARL's count and weight sum (``global_sum``, ``global_sum_with_grad``).

Inference is Faster R-CNN's, module for module.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ...core.bbox import bbox_overlaps_aligned
from ...parallel.mesh import all_gather, global_sum, process_index
from ...registry import DETECTORS, HEADS
from ..dense_heads.pisa_heads import EPS, carl_weights, isr_weights_masks
from ..detectors.two_stage import TwoStageDetector
from .standard_roi_head import StandardRoIHead, class_deltas

RANK_CAP = 512  # the positives ISR-P ranks, pairwise (pisa_roi_head.py:55)


@HEADS.register_module()
class PISARoIHead(StandardRoIHead):
    """``StandardRoIHead``'s keyword arguments and tpudet's fields
    (``pisa_roi_head.py:217-221``)."""

    def __init__(self, num_classes: int, in_channels: int = 256,
                 isr_k: float = 2.0, isr_bias: float = 0.0,
                 carl_k: float = 1.0, carl_bias: float = 0.2,
                 smooth_l1_beta: float = 1.0, **kwargs):
        super().__init__(num_classes, in_channels, **kwargs)
        self.isr_k, self.isr_bias = isr_k, isr_bias
        self.carl_k, self.carl_bias = carl_k, carl_bias
        self.smooth_l1_beta = smooth_l1_beta

    def rank_set(self, reg, labels, targets, pos, rois):
        """ISR-P's inputs over the whole batch, in its rank order: ``(order
        (K,) into the flattened slots of every rank, their IoUs, positive
        mask, same-gt and same-label (K, K) masks, the count of every
        rank's slots)``."""
        gt_boxes = self.bbox_coder.decode(rois, targets)
        ious = bbox_overlaps_aligned(
            self.bbox_coder.decode(rois, reg.detach()), gt_boxes)
        b, s = labels.shape
        rows = all_gather(torch.cat([pos[..., None].to(ious.dtype),
                                     labels[..., None].to(ious.dtype),
                                     ious[..., None], gt_boxes], -1))
        rows = rows.reshape(-1, rows.shape[-1])
        pos_f, lab_f, iou_f, gt_f = (rows[:, 0] > 0, rows[:, 1], rows[:, 2],
                                     rows[:, 3:])
        img_id = torch.arange(rows.shape[0], device=rows.device) // s
        sort_key = torch.where(pos_f, -iou_f, torch.full_like(iou_f, 2.0))
        order = torch.argsort(sort_key, stable=True)[:min(RANK_CAP,
                                                          rows.shape[0])]
        o_pos, o_lab, o_iou = pos_f[order], lab_f[order], iou_f[order]
        o_img, o_gt = img_id[order], gt_f[order]
        pp = o_pos[:, None] & o_pos[None, :]
        same_label = (o_lab[:, None] == o_lab[None, :]) & pp
        same_gt = same_label & (o_img[:, None] == o_img[None, :]) & (
            o_gt[:, None] == o_gt[None, :]).all(dim=-1)
        return order, o_iou, o_pos, same_gt, same_label, rows.shape[0]

    def loss(self, cls_logits, deltas, labels, targets, pos, sampled,
             rois=None) -> Dict:
        assert rois is not None, 'PISARoIHead.loss needs the sampled rois'
        b, s = labels.shape
        num_total = torch.clamp_min(global_sum(sampled.float().sum()), 1.0)
        logits = cls_logits.float()
        ce = -torch.gather(F.log_softmax(logits, dim=-1), -1,
                           labels[..., None])[..., 0]
        reg = class_deltas(deltas, labels, self.num_classes)

        order, o_iou, o_pos, same_gt, same_label, n_all = self.rank_set(
            reg, labels, targets, pos, rois.float())
        imp_k = isr_weights_masks(o_iou, same_gt, same_label, o_pos,
                                  self.isr_k, self.isr_bias)
        imp = imp_k.new_ones(n_all)
        imp[order] = imp_k
        start = process_index() * b * s
        imp = imp[start:start + b * s].reshape(b, s)
        pos_ce = (ce * pos).detach()
        ratio = global_sum(pos_ce.sum()) / torch.clamp_min(
            global_sum((pos_ce * imp).sum()), EPS)
        imp = torch.where(pos, imp * ratio, torch.ones_like(imp)).detach()
        loss_cls = (ce * imp * sampled).sum() / num_total

        diff = (reg - targets).abs()
        beta = self.smooth_l1_beta
        sl1 = torch.where(diff < beta, 0.5 * diff * diff / beta,
                          diff - 0.5 * beta)
        loss_bbox = (sl1 * pos[..., None].float()).sum() / num_total
        p_cls = torch.gather(F.softmax(logits, dim=-1), -1, labels.clamp(
            0, self.num_classes - 1)[..., None])[..., 0]
        cw = carl_weights(p_cls.reshape(-1), pos.reshape(-1), self.carl_k,
                          self.carl_bias).reshape(b, s)
        loss_carl = (sl1.sum(-1) * cw * pos).sum() / num_total
        return dict(loss_cls=loss_cls, loss_bbox=loss_bbox,
                    loss_carl=loss_carl)


@DETECTORS.register_module()
class PISAFasterRCNN(TwoStageDetector):
    """Named wrapper for configs/pisa/pisa_faster_rcnn_* (the reference
    reuses type='FasterRCNN' with the roi_head type swapped)."""
