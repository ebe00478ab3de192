"""Cascade R-CNN: port of ``tpudet/models/roi_heads/cascade_roi_head.py``
(``CascadeRoIHead``, ``CascadeRCNN``).

Three ``Shared2FCBBoxHead``s (``bbox_head0..2``), class-agnostic, each
with its stage's delta stds (``STAGE_STDS``), trained at IoU 0.5 / 0.6 /
0.7 with ``match_low_quality=False``, smooth L1 (beta 1) and the stage
weights 1 / 0.5 / 0.25:

- training: stage 0 samples its rois as ``StandardRoIHead`` does
  (``return_is_gt``); each later stage assigns every valid roi of the
  previous stage's refined boxes at its IoU, with no new sampling; the
  slots that came from the appended gts stay the pristine gt boxes (the
  reference drops gt-origin rois when it refines and re-appends the
  gts); refined boxes are decoded clipped to the image and detached;
- testing: the three stages' softmaxes averaged, and the last stage's
  deltas decoded on the twice-refined rois, clipped to the image, then the
  class-offset NMS of every (roi, class) pair.

The loss denominators count every rank's sampled slots
(``StandardRoIHead.loss``, ``parallel/mesh.global_sum``), stage by stage.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...core.assigners import max_iou_assign_batch
from ...core.bbox import DeltaXYWHBBoxCoder
from ...core.nms import NMSResult, _gather_rows
from ...registry import DETECTORS, HEADS
from ..detectors.two_stage import TwoStageDetector, rcnn_kwargs
from .bbox_head import Shared2FCBBoxHead
from .standard_roi_head import StandardRoIHead, pair_nms

STAGE_IOUS = (0.5, 0.6, 0.7)
STAGE_STDS = ((0.1, 0.1, 0.2, 0.2), (0.05, 0.05, 0.1, 0.1),
              (0.033, 0.033, 0.067, 0.067))
STAGE_WEIGHTS = (1.0, 0.5, 0.25)


@HEADS.register_module()
class CascadeRoIHead(StandardRoIHead):
    """``StandardRoIHead``'s keyword arguments (its 2-FC ``bbox_head``
    replaced by the stages' heads), ``num_stages`` and tpudet's
    ``loss_bbox_type='smooth_l1'``."""

    def __init__(self, num_classes: int, num_stages: int = 3,
                 loss_bbox_type: str = 'smooth_l1', **kwargs):
        super().__init__(num_classes, loss_bbox_type=loss_bbox_type,
                         **kwargs)
        del self.bbox_head
        self.num_stages = num_stages
        in_channels = kwargs.get('in_channels', 256)
        for i in range(num_stages):
            self.add_module(f'bbox_head{i}', Shared2FCBBoxHead(
                num_classes, in_channels, roi_feat_size=self.roi_size,
                reg_class_agnostic=True, target_stds=STAGE_STDS[i]))
        self.stage_coders = [DeltaXYWHBBoxCoder(target_stds=STAGE_STDS[i])
                             for i in range(num_stages)]

    def run_stage(self, stage: int, feats, rois, roi_valid):
        """Pool ``rois`` and run stage ``stage``'s head: (B, P, C + 1)
        logits, (B, P, 4) deltas."""
        return getattr(self, f'bbox_head{stage}')(
            self.extract(feats, rois, roi_valid))

    def refine(self, stage: int, rois, deltas, img_shape=None):
        """Stage ``stage``'s deltas decoded on ``rois``, clipped to
        ``img_shape`` (h, w)."""
        return self.stage_coders[stage].decode(rois, deltas.float(),
                                               max_shape=img_shape)

    def stage_targets(self, stage: int, rois, roi_valid, gt_bboxes,
                      gt_labels, gt_valid):
        """Every valid roi assigned at the stage's IoU, no low-quality
        match and no sampling: ``(sampled, labels, targets, pos)``."""
        thr = STAGE_IOUS[stage]
        gt_bboxes = gt_bboxes.float()
        assigned = max_iou_assign_batch(rois, gt_bboxes, gt_valid, thr, thr,
                                        thr, False)
        assigned = torch.where(roi_valid, assigned, -2)
        pos = assigned >= 0
        sampled = pos | (assigned == -1)
        gt_idx = assigned.clamp_min(0)
        labels = torch.where(pos, torch.gather(gt_labels.long(), 1, gt_idx),
                             self.num_classes)
        matched = torch.where(pos[..., None], _gather_rows(gt_bboxes, gt_idx),
                              rois)
        return (sampled, labels,
                self.stage_coders[stage].encode(rois, matched), pos)


@DETECTORS.register_module()
class CascadeRCNN(TwoStageDetector):
    """``forward(img)`` -> ``(rois (B, P, 4) twice refined, valid (B, P),
    mean class probabilities (B, P, C + 1), last stage's deltas (B, P, 4),
    img_hw (2,))``, all that ``get_bboxes`` reads."""

    def stage_context(self, feats) -> dict:
        """Keyword arguments of every ``run_stage`` call on ``feats``
        beyond the rois (HTC's semantic embedding, SCNet's global
        context); none here."""
        return {}

    def detect(self, feats, img_shape):
        head = self.roi_head
        rois, roi_valid = self.eval_proposals(feats, img_shape)
        ctx = self.stage_context(feats)
        prob_sum = 0.
        for stage in range(head.num_stages):
            cls_logits, deltas = head.run_stage(stage, feats, rois,
                                                roi_valid, **ctx)[:2]
            prob_sum = prob_sum + F.softmax(cls_logits.float(), dim=-1)
            if stage < head.num_stages - 1:
                rois = head.refine(stage, rois, deltas, img_shape)
        img_hw = torch.tensor(img_shape, dtype=torch.float32,
                              device=rois.device)
        return rois, roi_valid, prob_sum / head.num_stages, deltas, img_hw

    def two_stage_losses(self, feats, img, gt_bboxes, gt_labels, gt_valid):
        """The RPN loss and each stage's weighted losses
        (``loss_cls_s{i}``, ``loss_bbox_s{i}``), and stage 0's sampled
        rois: ``(losses, (rois, sampled, labels, pos))``."""
        head = self.roi_head
        losses, proposals, prop_valid = self.train_proposals(
            feats, img, gt_bboxes, gt_labels, gt_valid)
        rois, sampled0, labels0, targets0, pos0, is_gt = head.sample_rois(
            proposals, prop_valid, gt_bboxes, gt_labels, gt_valid,
            return_is_gt=True)
        stage0 = (rois, sampled0, labels0, pos0)
        img_shape = tuple(img.shape[1:3])
        for stage in range(head.num_stages):
            cls_logits, deltas = head.run_stage(stage, feats, rois, sampled0)
            if stage == 0:
                sampled, labels, targets, pos = (sampled0, labels0, targets0,
                                                 pos0)
            else:
                sampled, labels, targets, pos = head.stage_targets(
                    stage, rois, sampled0, gt_bboxes, gt_labels, gt_valid)
            stage_losses = head.loss(cls_logits, deltas, labels, targets,
                                     pos, sampled)
            w = STAGE_WEIGHTS[stage]
            losses[f'loss_cls_s{stage}'] = stage_losses['loss_cls'] * w
            losses[f'loss_bbox_s{stage}'] = stage_losses['loss_bbox'] * w
            if stage < head.num_stages - 1:
                refined = head.refine(stage, rois, deltas.detach(),
                                      img_shape)
                rois = torch.where(is_gt[..., None], rois, refined)
        return losses, stage0

    def get_bboxes(self, outputs, scale_factors=None, **kwargs
                   ) -> NMSResult:
        """Detections of ``forward``'s outputs by ``test_cfg.rcnn``;
        ``kwargs`` (``img_shape``) are not read: the boxes are clipped to
        the network input, as tpudet's."""
        rois, roi_valid, probs, deltas, img_hw = outputs
        head = self.roi_head
        boxes = head.refine(head.num_stages - 1, rois, deltas,
                            (img_hw[0], img_hw[1]))
        scores = probs[..., :-1] * roi_valid[..., None]
        if scale_factors is not None:
            boxes = boxes / torch.as_tensor(
                scale_factors, dtype=boxes.dtype,
                device=boxes.device)[:, None, :]
        b, p, c = scores.shape
        return pair_nms(boxes[:, :, None].expand(b, p, c, 4), scores,
                        **rcnn_kwargs(self.test_cfg))
