"""Two-stage detector (Faster R-CNN): port of
``tpudet/models/detectors/two_stage.py``.

- ``forward(img)``: features -> RPN -> proposals by ``test_cfg.rpn``
  (clipped to the padded canvas, as tpudet's) -> RoI head: ``(proposals,
  valid, cls_logits, deltas)``, all that ``get_bboxes`` reads;
- ``forward_train(img, gt_bboxes, gt_labels, gt_valid)``: the RPN loss,
  proposals by ``train_cfg.rpn_proposal`` (detached, as tpudet stops their
  gradient), roi sampling and the RoI losses: the loss dict, with
  ``num_gts``;
- ``get_bboxes(outputs)``: the RoI head's decode and NMS by
  ``test_cfg.rcnn``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ...registry import DETECTORS
from .base import BaseDetector


def proposal_kwargs(cfg: Dict, nms_pre: int) -> Dict:
    """``get_proposals`` arguments of an ``rpn`` / ``rpn_proposal`` cfg."""
    return dict(nms_pre=cfg.get('nms_pre', nms_pre),
                max_num=cfg.get('max_per_img', 1000),
                iou_thr=cfg.get('nms', {}).get('iou_threshold', 0.7))


def rcnn_kwargs(test_cfg: Optional[Dict]) -> Dict:
    """``StandardRoIHead.get_bboxes`` arguments of ``test_cfg.rcnn``."""
    cfg = dict(test_cfg or {}).get('rcnn', {})
    return dict(score_thr=cfg.get('score_thr', 0.05),
                iou_thr=cfg.get('nms', {}).get('iou_threshold', 0.5),
                max_per_img=cfg.get('max_per_img', 100))


@DETECTORS.register_module()
class TwoStageDetector(BaseDetector):

    def __init__(self, backbone: nn.Module, rpn_head: nn.Module,
                 roi_head: nn.Module, neck: Optional[nn.Module] = None,
                 train_cfg: Optional[Dict] = None,
                 test_cfg: Optional[Dict] = None):
        super().__init__(backbone, neck, train_cfg, test_cfg)
        self.rpn_head = rpn_head
        self.roi_head = roi_head

    def forward(self, img):
        """img (B, H, W, 3), normalized -> ``(proposals (B, P, 4), valid
        (B, P), cls_logits (B, P, C + 1), deltas (B, P, 4C))``."""
        feats = self.extract_feat(img)
        rpn_preds = self.rpn_head(feats)
        cfg = dict(self.test_cfg or {}).get('rpn', {})
        proposals, _, prop_valid = self.rpn_head.get_proposals(
            rpn_preds, img_shape=tuple(img.shape[1:3]),
            **proposal_kwargs(cfg, 1000))
        proposals = proposals.detach()
        cls_logits, deltas = self.roi_head(feats, proposals, prop_valid)
        return proposals, prop_valid, cls_logits, deltas

    def forward_train(self, img, gt_bboxes, gt_labels, gt_valid
                      ) -> Dict[str, torch.Tensor]:
        """The RPN and RoI losses of a batch (padded gts, xyxy)."""
        feats = self.extract_feat(img)
        rpn_preds = self.rpn_head(feats)
        losses = self.rpn_head.loss(rpn_preds, gt_bboxes, gt_labels,
                                    gt_valid)
        cfg = dict(self.train_cfg or {}).get('rpn_proposal', {})
        proposals, _, prop_valid = self.rpn_head.get_proposals(
            rpn_preds, img_shape=tuple(img.shape[1:3]),
            **proposal_kwargs(cfg, 2000))
        proposals = proposals.detach()
        rois, sampled, labels, targets, pos = self.roi_head.sample_rois(
            proposals, prop_valid, gt_bboxes, gt_labels, gt_valid)
        cls_logits, deltas = self.roi_head(feats, rois, sampled)
        losses.update(self.roi_head.loss(cls_logits, deltas, labels,
                                         targets, pos, sampled, rois=rois))
        losses['num_gts'] = gt_valid.float().sum(dim=1).mean()
        return losses

    def get_bboxes(self, outputs, scale_factors=None, **kwargs):
        """Detections of ``forward``'s outputs (``test_cfg.rcnn``);
        ``kwargs`` (``img_shape``) go to the RoI head."""
        proposals, prop_valid, cls_logits, deltas = outputs
        return self.roi_head.get_bboxes(
            proposals, prop_valid, cls_logits, deltas,
            scale_factors=scale_factors,
            **{**rcnn_kwargs(self.test_cfg), **kwargs})


@DETECTORS.register_module()
class FasterRCNN(TwoStageDetector):
    """Named alias (reference mmdet/models/detectors/faster_rcnn.py)."""
