"""Mask Scoring R-CNN: port of
``tpudet/models/roi_heads/mask_scoring_roi_head.py`` (``MaskIoUHead``,
``MaskScoringRoIHead``, ``MaskScoringRCNN``).

- ``MaskIoUHead``: the RoI features (N, 14, 14, C) and the detected
  class's mask probabilities (N, 28, 28), max-pooled 2x2 to 14 x 14 and
  concatenated as one more channel, through four 3x3 convs (the last at
  stride 2, flax's ``'SAME'`` padding: (0, 1)) and three FCs to a
  per-class IoU, fp32. Convs ``he_normal``, FCs ``xavier_uniform``,
  ``fc_mask_iou`` N(0, 0.01^2);
- ``MaskScoringRoIHead.mask_iou_forward``: as tpudet's, the head's input
  is the rois' 7 x 7 bbox-branch pooling repeated 2x2 to 14 x 14;
  ``mask_iou_loss`` is 0.5 x the squared error against the IoU of the
  binarised prediction and target (the target detached) over the
  positives, divided by max(positives, 1);
- ``MaskScoringRCNN.forward_train``: Mask R-CNN's losses and
  ``loss_mask_iou`` (its gradient reaches the mask head through the
  probabilities and the backbone through the pooled features).

As in tpudet, the IoU head runs only in training: the detector keeps
``MaskRCNN.predict_masks`` and rescores nothing at test time (the module
docstring of tpudet says otherwise; its code does not).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.deform_conv import same_padding
from ...parallel.mesh import global_sum
from ...registry import DETECTORS, HEADS
from ..layers import Conv, Dense
from .mask_head import MaskRCNN, MaskRoIHead, class_channel, mask_targets


class MaskIoUHead(nn.Module):

    def __init__(self, num_classes: int, in_channels: int = 256,
                 conv_out_channels: int = 256, fc_out_channels: int = 1024,
                 roi_feat_size: int = 14):
        super().__init__()
        cin = in_channels + 1
        for i in range(4):
            self.add_module(f'conv{i}', Conv(cin, conv_out_channels, 3,
                                             2 if i == 3 else 1,
                                             padding=0))
            cin = conv_out_channels
        side = -(-roi_feat_size // 2)
        cin = conv_out_channels * side * side
        for i in range(3):
            self.add_module(f'fc{i}', Dense(cin, fc_out_channels))
            cin = fc_out_channels
        self.fc_mask_iou = Dense(cin, num_classes,
                                 kernel_init=('normal', 0.01))

    def forward(self, roi_feats, mask_pred):
        """roi_feats (N, 14, 14, C), mask_pred (N, 28, 28) -> (N,
        num_classes) fp32."""
        mp = F.max_pool2d(mask_pred[:, None], 2, 2)
        x = torch.cat([roi_feats.permute(0, 3, 1, 2), mp.to(roi_feats.dtype)],
                      dim=1)
        for i in range(4):
            stride = 2 if i == 3 else 1
            (top, bottom), (left, right) = (same_padding(n, 3, stride)
                                            for n in x.shape[2:])
            x = F.relu(getattr(self, f'conv{i}')(
                F.pad(x, (left, right, top, bottom))))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        for i in range(3):
            x = F.relu(getattr(self, f'fc{i}')(x))
        return self.fc_mask_iou(x).float()


@HEADS.register_module()
class MaskScoringRoIHead(MaskRoIHead):
    """``MaskRoIHead``'s keyword arguments; the IoU head reads
    ``in_channels`` + 1 channels."""

    def __init__(self, num_classes: int, in_channels: int = 256, **kwargs):
        super().__init__(num_classes, in_channels, **kwargs)
        self.mask_iou_head = MaskIoUHead(num_classes, in_channels)

    def mask_iou_forward(self, feats, rois, roi_valid, mask_logits, labels):
        """The predicted mask IoU of each roi at its label's class: (B,
        P)."""
        pooled = self.extract(feats, rois, roi_valid)
        b, p = pooled.shape[:2]
        x = pooled.reshape((b * p,) + pooled.shape[2:])
        x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        mp = class_channel(torch.sigmoid(mask_logits), labels,
                           self.num_classes)
        ious = self.mask_iou_head(x, mp.reshape((b * p,) + mp.shape[2:]))
        return class_channel(ious.reshape(b, p, -1), labels,
                             self.num_classes)

    def mask_iou_loss(self, pred_ious, mask_logits, rois, pos, gt_idx,
                      gt_boxes, gt_frame_masks, labels
                      ) -> Dict[str, torch.Tensor]:
        """``loss_mask_iou``: 0.5 x the squared error against the IoU of
        the binarised prediction (sigmoid > 0.5) and target (> 0.5) over
        the positives / max(positives, 1) (``mask_scoring_roi_head.py:
        79-107``)."""
        dtype = torch.promote_types(pred_ious.dtype, torch.float32)
        targets = mask_targets(rois, gt_idx, gt_boxes, gt_frame_masks,
                               self.mask_size, dtype)
        per_roi = class_channel(mask_logits, labels, self.num_classes)
        pm = (torch.sigmoid(per_roi) > 0.5).to(dtype)
        tm = (targets > 0.5).to(dtype)
        inter = (pm * tm).sum(dim=(2, 3))
        union = torch.maximum(pm, tm).sum(dim=(2, 3))
        true_iou = (inter / torch.clamp_min(union, 1.0)).detach()
        w = pos.to(dtype)
        num = torch.clamp_min(global_sum(w.sum()), 1.0)
        return dict(loss_mask_iou=0.5 * ((pred_ious - true_iou) ** 2 * w
                                         ).sum() / num)


@DETECTORS.register_module()
class MaskScoringRCNN(MaskRCNN):
    """Mask R-CNN with the IoU head's loss in training
    (``mask_scoring_roi_head.py:110-147``)."""

    def forward_train(self, img, gt_bboxes, gt_labels, gt_valid,
                      gt_frame_masks) -> Dict[str, torch.Tensor]:
        losses, (feats, rois, sampled, labels, pos, gt_idx, gt_bboxes,
                 mask_logits) = self.mask_losses(
            img, gt_bboxes, gt_labels, gt_valid, gt_frame_masks)
        head = self.roi_head
        pred_ious = head.mask_iou_forward(feats, rois, sampled, mask_logits,
                                          labels)
        losses.update(head.mask_iou_loss(pred_ious, mask_logits, rois, pos,
                                         gt_idx, gt_bboxes, gt_frame_masks,
                                         labels))
        return losses
