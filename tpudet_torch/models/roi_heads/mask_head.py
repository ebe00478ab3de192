"""The FCN mask head and Mask R-CNN: port of
``tpudet/models/roi_heads/mask_head.py``.

- ``FCNMaskHead``: 14 x 14 pooled RoI features -> 4 conv3x3 + ReLU -> a
  2x2 stride-2 transposed conv + ReLU -> a 1x1 per-class logit conv:
  (..., 28, 28, num_classes) logits. The convs draw ``he_normal``,
  ``conv_logits`` N(0, 0.001^2), all with zero biases;
- ``MaskRoIHead``: ``StandardRoIHead`` with that head; ``mask_forward``
  pools its own 14 x 14 features, ``mask_loss`` is the BCE of the matched
  class's channel against targets resampled from the gt-frame masks
  (``core/mask.py``), over the positive slots, divided by max(positives,
  1) x 28^2;
- ``MaskRCNN``: ``forward_train`` adds ``gt_frame_masks`` (B, G, S, S) to
  the two-stage losses (the mask branch runs on every sampled slot and
  the loss masks the positives; gt indices from a MaxIoU assignment of
  the rois at 0.5); ``predict_masks`` returns (B, D, 28, 28, C) sigmoid
  probabilities for given detections. It takes the features of the same
  call where the caller has them (tpudet computes them a second time: the
  same values).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...core.assigners import max_iou_assign_batch
from ...core.mask import mask_targets_from_gt_frame
from ...parallel.mesh import global_count, global_sum
from ...registry import DETECTORS, HEADS
from .. import losses as L
from ..detectors.two_stage import TwoStageDetector
from ..layers import Conv, ConvTranspose
from .standard_roi_head import StandardRoIHead

MASK_ROI_SIZE = 14


@HEADS.register_module()
class FCNMaskHead(nn.Module):
    """The keyword arguments are tpudet's fields (``mask_head.py:24-29``)
    with its defaults."""

    def __init__(self, num_classes: int, in_channels: int = 256,
                 conv_out_channels: int = 256, num_convs: int = 4,
                 dtype=None):
        super().__init__()
        if dtype is not None:
            raise ValueError(f'FCNMaskHead: dtype={dtype!r} is not a module '
                             f'setting in the port; see '
                             f'TwoStageDetector.set_dtype')
        self.num_convs = num_convs
        for i in range(num_convs):
            setattr(self, f'conv{i}', Conv(
                in_channels if i == 0 else conv_out_channels,
                conv_out_channels, 3, padding=1))
        self.upsample = ConvTranspose(
            conv_out_channels if num_convs else in_channels,
            conv_out_channels, 2, stride=2)
        self.conv_logits = Conv(conv_out_channels, num_classes, 1,
                                kernel_init=('normal', 0.001))

    def forward(self, roi_feats):
        """(..., 14, 14, C) -> (..., 28, 28, num_classes) logits."""
        lead = roi_feats.shape[:-3]
        x = roi_feats.reshape((-1,) + roi_feats.shape[-3:]).permute(0, 3, 1,
                                                                      2)
        for i in range(self.num_convs):
            x = F.relu(getattr(self, f'conv{i}')(x))
        x = F.relu(self.upsample(x))
        x = self.conv_logits(x).permute(0, 2, 3, 1)
        return x.reshape(lead + x.shape[1:])


@HEADS.register_module()
class MaskRoIHead(StandardRoIHead):
    """``StandardRoIHead`` with the mask branch; the keyword arguments are
    ``StandardRoIHead``'s and tpudet's ``mask_size`` (the targets' side)."""

    def __init__(self, num_classes: int, in_channels: int = 256,
                 mask_size: int = 28, **kwargs):
        super().__init__(num_classes, in_channels, **kwargs)
        self.mask_size = mask_size
        self.mask_head = FCNMaskHead(num_classes=num_classes,
                                     in_channels=in_channels)

    def mask_forward(self, feats, rois, roi_valid):
        """Pool 14 x 14 features of ``rois`` (B, P, 4) and run the mask
        head: (B, P, 28, 28, num_classes) logits."""
        return self.mask_head(self.extract(feats, rois, roi_valid,
                                           out_size=MASK_ROI_SIZE))

    def mask_loss(self, mask_logits, rois, pos, gt_idx, gt_boxes,
                  gt_frame_masks, labels) -> Dict[str, torch.Tensor]:
        """BCE of the matched class's channel over the positive slots, in
        fp32 or the logits' wider dtype (``mask_head.py:72-95``)."""
        b, p = rois.shape[:2]
        dtype = torch.promote_types(mask_logits.dtype, torch.float32)
        gt_idx = gt_idx.clamp_min(0)
        batch = torch.arange(b, device=rois.device)[:, None]
        matched_masks = gt_frame_masks.to(dtype)[batch, gt_idx]  # (B, P, S, S)
        matched_boxes = gt_boxes.to(dtype)[batch, gt_idx]
        s = matched_masks.shape[-1]
        targets = mask_targets_from_gt_frame(
            matched_masks.reshape(b * p, s, s), matched_boxes.reshape(-1, 4),
            rois.reshape(-1, 4).to(dtype), self.mask_size).reshape(
                b, p, self.mask_size, self.mask_size)
        cls_idx = labels.long().clamp(0, self.num_classes - 1)
        per_roi = torch.gather(
            mask_logits.to(dtype), -1,
            cls_idx[:, :, None, None, None].expand(
                b, p, self.mask_size, self.mask_size, 1))[..., 0]
        bce = L.binary_cross_entropy_with_logits(per_roi,
                                                 targets.clamp(0., 1.))
        pos = pos.to(dtype)
        denom = torch.clamp_min(global_sum(pos.sum()), 1.0) * \
            self.mask_size ** 2
        return dict(loss_mask=(bce * pos[:, :, None, None]).sum() / denom)


@DETECTORS.register_module()
class MaskRCNN(TwoStageDetector):
    """Mask R-CNN (``mask_head.py:98-147``)."""

    def forward_train(self, img, gt_bboxes, gt_labels, gt_valid,
                      gt_frame_masks) -> Dict[str, torch.Tensor]:
        """The two-stage losses of a batch and ``loss_mask``; the gts are
        padded xyxy boxes and their (B, G, S, S) gt-frame masks."""
        feats = self.extract_feat(img)
        losses, (rois, sampled, labels, pos) = self.two_stage_losses(
            feats, img, gt_bboxes, gt_labels, gt_valid)
        gt_bboxes = torch.as_tensor(gt_bboxes).float()
        gt_idx = max_iou_assign_batch(rois, gt_bboxes, gt_valid, 0.5, 0.5,
                                      0.5, True)
        mask_logits = self.roi_head.mask_forward(feats, rois, sampled)
        losses.update(self.roi_head.mask_loss(
            mask_logits, rois, pos, gt_idx, gt_bboxes, gt_frame_masks,
            labels))
        losses['num_gts'] = (gt_valid.float().sum() / global_count(
            gt_valid.shape[0], gt_valid.device))
        return losses

    def predict_masks(self, img, det_bboxes, det_valid,
                      feats: Optional[list] = None) -> torch.Tensor:
        """Mask probabilities of given detections (boxes in the network
        input's frame): (B, D, 28, 28, num_classes) sigmoid outputs.
        ``feats``, the features of ``img`` from the same call, are reused
        where given."""
        if feats is None:
            feats = self.extract_feat(img)
        return torch.sigmoid(self.roi_head.mask_forward(feats, det_bboxes,
                                                        det_valid))
