"""Proposal-only and proposal-fed detectors: port of
``tpudet/models/detectors/rpn.py``.

- ``RPN``: the RPN as a detector. Training is the RPN head's loss
  (``loss``); inference returns the NMS-filtered proposals as
  class-agnostic detections, label 0.
- ``FastRCNN``: the RoI stage on proposals the caller supplies, padded
  ``(B, P, 4)`` with their validity, at train and test time.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ...core.nms import NMSResult
from ...parallel.mesh import global_count
from ...registry import DETECTORS
from .base import BaseDetector
from .two_stage import proposal_kwargs, rcnn_kwargs


@DETECTORS.register_module()
class RPN(BaseDetector):

    def __init__(self, backbone: nn.Module, rpn_head: nn.Module,
                 neck: Optional[nn.Module] = None,
                 train_cfg: Optional[Dict] = None,
                 test_cfg: Optional[Dict] = None):
        super().__init__(backbone, neck, train_cfg, test_cfg)
        self.rpn_head = rpn_head

    def forward(self, img):
        """img (B, H, W, 3) -> the RPN head's per-level pred maps."""
        return self.rpn_head(self.extract_feat(img))

    def loss(self, preds, gt_bboxes, gt_labels, gt_valid):
        """The RPN head's loss (class-agnostic objectness)."""
        return self.rpn_head.loss(preds, gt_bboxes, gt_labels, gt_valid)

    def get_bboxes(self, preds, scale_factors=None, **kwargs) -> NMSResult:
        """Proposals by ``test_cfg.rpn`` (or ``test_cfg`` itself), not
        clipped (tpudet passes no ``img_shape`` here; ``kwargs`` are
        dropped), with ``min_bbox_size``; label 0."""
        test_cfg = self.test_cfg or {}
        cfg = dict(test_cfg).get('rpn', test_cfg)
        props, scores, valid = self.rpn_head.get_proposals(
            preds, min_bbox_size=cfg.get('min_bbox_size', 0.),
            **proposal_kwargs(cfg, 1000))
        if scale_factors is not None:
            props = props / torch.as_tensor(
                scale_factors, dtype=props.dtype,
                device=props.device)[:, None, :]
        return NMSResult(props, scores, torch.zeros_like(valid,
                                                         dtype=torch.long),
                         valid)


@DETECTORS.register_module()
class FastRCNN(BaseDetector):

    def __init__(self, backbone: nn.Module, roi_head: nn.Module,
                 neck: Optional[nn.Module] = None,
                 train_cfg: Optional[Dict] = None,
                 test_cfg: Optional[Dict] = None):
        super().__init__(backbone, neck, train_cfg, test_cfg)
        self.roi_head = roi_head

    def forward(self, img, proposals, prop_valid):
        """``(proposals, valid, cls_logits, deltas)`` of the given
        proposals (B, P, 4), detached, and their validity (B, P)."""
        feats = self.extract_feat(img)
        proposals = proposals.detach()
        cls_logits, deltas = self.roi_head(feats, proposals, prop_valid)
        return proposals, prop_valid, cls_logits, deltas

    def forward_train(self, img, proposals, prop_valid, gt_bboxes,
                      gt_labels, gt_valid) -> Dict[str, torch.Tensor]:
        feats = self.extract_feat(img)
        rois, sampled, labels, targets, pos = self.roi_head.sample_rois(
            proposals, prop_valid, gt_bboxes, gt_labels, gt_valid)
        cls_logits, deltas = self.roi_head(feats, rois, sampled)
        losses = self.roi_head.loss(cls_logits, deltas, labels, targets,
                                    pos, sampled, rois=rois)
        losses['num_gts'] = (gt_valid.float().sum() / global_count(
            gt_valid.shape[0], gt_valid.device))
        return losses

    def get_bboxes(self, outputs, scale_factors=None, **kwargs):
        proposals, prop_valid, cls_logits, deltas = outputs
        return self.roi_head.get_bboxes(
            proposals, prop_valid, cls_logits, deltas,
            scale_factors=scale_factors,
            **{**rcnn_kwargs(self.test_cfg), **kwargs})
