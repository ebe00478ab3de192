"""Hybrid Task Cascade: port of ``tpudet/models/roi_heads/htc_roi_head.py``
(``FusedSemanticHead``, ``HTCRoIHead``, ``HybridTaskCascade``).

On the Cascade R-CNN stages (``cascade_roi_head.py``):

- ``FusedSemanticHead``: a 1x1 lateral per FPN level, each brought to the
  ``fusion_level``'s size by ``ops/resize.resize_bilinear`` (jax's
  antialiased bilinear: P2 down, P4-P6 up) and summed, four 3x3 convs
  with ReLU, then the ReLU'd 1x1 embedding and the 1x1 logits (fp32).
  Every conv ``he_normal`` with a bias, the logits N(0, 0.01^2);
- the embedding's RoIAlign crops (``rois / semantic_stride``, no roi
  masked) are added to each stage's 7 x 7 bbox features and 14 x 14 mask
  features;
- a ``FCNMaskHead`` a stage (``mask_head{i}``) with mask information
  flow: from stage 1 on, the previous stage's 14 x 14 mask features pass a
  1x1 conv (``mask_info{i - 1}``) and are added to this stage's;
- training interleaves the stages: each stage's mask branch runs on that
  stage's rois (assigned at IoU 0.5) with its weighted loss
  ``loss_mask_s{i}``; unlike Cascade R-CNN's, HTC's refine replaces every
  slot, the gt-origin ones too, as tpudet's; ``gt_semantic_seg`` (B, H/8,
  W/8), when given, adds ``loss_semantic_seg``: 0.2 x the mean CE of the
  logits at the labels clipped into the classes.

As in tpudet, ``HybridTaskCascade`` has no ``predict_masks``: its
evaluation is bbox only, and a test with masks raises "has no mask
branch". No tpudet pipeline makes ``gt_semantic_seg``: the CE runs only
where a caller passes one.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...core.assigners import max_iou_assign_batch
from ...ops.resize import resize_bilinear
from ...ops.roi_align import batched_roi_align
from ...parallel.mesh import global_count, global_mean
from ...registry import DETECTORS, HEADS
from ..layers import Conv
from .cascade_roi_head import STAGE_WEIGHTS, CascadeRCNN, CascadeRoIHead
from .mask_head import MASK_ROI_SIZE, FCNMaskHead, mask_bce_loss


class FusedSemanticHead(nn.Module):
    """``forward(feats)`` on ``num_ins`` NCHW levels -> (embedding (B, C,
    h, w) at the fusion level, logits (B, num_classes, h, w) fp32)."""

    def __init__(self, num_classes: int = 183, in_channels: int = 256,
                 conv_out_channels: int = 256, fusion_level: int = 1,
                 num_convs: int = 4, num_ins: int = 5):
        super().__init__()
        self.fusion_level = fusion_level
        self.num_ins = num_ins
        self.num_convs = num_convs
        for i in range(num_ins):
            self.add_module(f'lateral{i}', Conv(in_channels, in_channels, 1))
        cin = in_channels
        for i in range(num_convs):
            self.add_module(f'conv{i}', Conv(cin, conv_out_channels, 3,
                                             padding=1))
            cin = conv_out_channels
        self.conv_embedding = Conv(cin, conv_out_channels, 1)
        self.conv_logits = Conv(cin, num_classes, 1,
                                kernel_init=('normal', 0.01))

    def forward(self, feats):
        th, tw = feats[self.fusion_level].shape[2:]
        fused = None
        for i, f in enumerate(feats[:self.num_ins]):
            v = getattr(self, f'lateral{i}')(f)
            if f.shape[2] != th:
                v = resize_bilinear(v, v.shape[:2] + (th, tw))
            fused = v if fused is None else fused + v
        x = fused
        for i in range(self.num_convs):
            x = F.relu(getattr(self, f'conv{i}')(x))
        return F.relu(self.conv_embedding(x)), self.conv_logits(x).float()


def semantic_roi_feats(sem_embedding, rois, stride: int, size: int):
    """RoIAlign crops (B, P, size, size, C) of the NCHW embedding at
    ``rois / stride``, no roi masked (tpudet's ``semantic_roi_feats``)."""
    return batched_roi_align(sem_embedding.permute(0, 2, 3, 1),
                             rois / stride, size)


@HEADS.register_module()
class HTCRoIHead(CascadeRoIHead):
    """``CascadeRoIHead``'s keyword arguments and tpudet's fields
    ``mask_size``, ``semantic_fusion``, ``num_semantic_classes``,
    ``semantic_stride``."""

    def __init__(self, num_classes: int, in_channels: int = 256,
                 mask_size: int = 28, semantic_fusion: bool = True,
                 num_semantic_classes: int = 183, semantic_stride: int = 8,
                 **kwargs):
        super().__init__(num_classes, in_channels=in_channels, **kwargs)
        self.mask_size = mask_size
        self.semantic_fusion = semantic_fusion
        self.num_semantic_classes = num_semantic_classes
        self.semantic_stride = semantic_stride
        for i in range(self.num_stages):
            self.add_module(f'mask_head{i}', FCNMaskHead(num_classes,
                                                         in_channels))
        for i in range(self.num_stages - 1):
            self.add_module(f'mask_info{i}', Conv(in_channels, in_channels,
                                                  1))
        if semantic_fusion:
            self.semantic_head = FusedSemanticHead(
                num_semantic_classes, in_channels, in_channels)

    def run_stage(self, stage: int, feats, rois, roi_valid,
                  sem_embedding=None):
        """Cascade's stage with the semantic crop added to the pooled
        features."""
        pooled = self.extract(feats, rois, roi_valid)
        if sem_embedding is not None:
            pooled = pooled + semantic_roi_feats(
                sem_embedding, rois, self.semantic_stride, self.roi_size)
        return getattr(self, f'bbox_head{stage}')(pooled)

    def mask_stage(self, stage: int, feats, rois, roi_valid, sem_embedding,
                   prev_mask_feat):
        """Stage ``stage``'s mask logits (B, P, 28, 28, C) and its 14 x 14
        features (B P, 14, 14, C), which the next stage receives."""
        pooled = self.extract(feats, rois, roi_valid, out_size=MASK_ROI_SIZE)
        b, p = pooled.shape[:2]
        x = pooled.reshape((b * p,) + pooled.shape[2:])
        if sem_embedding is not None:
            sem = semantic_roi_feats(sem_embedding, rois,
                                     self.semantic_stride, MASK_ROI_SIZE)
            x = x + sem.reshape((b * p,) + sem.shape[2:])
        if prev_mask_feat is not None:
            info = getattr(self, f'mask_info{stage - 1}')(
                prev_mask_feat.permute(0, 3, 1, 2))
            x = x + info.permute(0, 2, 3, 1)
        logits = getattr(self, f'mask_head{stage}')(x)
        return logits.reshape((b, p) + logits.shape[1:]), x

    def mask_loss(self, stage: int, mask_logits, rois, pos, gt_idx,
                  gt_boxes, gt_frame_masks, labels) -> torch.Tensor:
        """A stage's unweighted mask loss (``MaskRoIHead``'s)."""
        return mask_bce_loss(mask_logits, rois, pos, gt_idx, gt_boxes,
                             gt_frame_masks, labels, self.num_classes,
                             self.mask_size)

    def semantic_loss(self, seg_logits, gt_semantic_seg) -> torch.Tensor:
        """0.2 x the mean CE of the NCHW logits at the labels clipped into
        the classes (``htc_roi_head.py:216-223``), over every rank's
        pixels."""
        logp = F.log_softmax(seg_logits, dim=1)
        tgt = gt_semantic_seg.long().clamp(0, self.num_semantic_classes - 1)
        ce = -torch.gather(logp, 1, tgt[:, None])[:, 0]
        return 0.2 * global_mean(ce)


@DETECTORS.register_module()
class HybridTaskCascade(CascadeRCNN):
    """``forward`` as ``CascadeRCNN``'s, each stage fed the semantic
    embedding; ``forward_train`` takes ``gt_frame_masks`` (B, G, S, S)
    and, optionally, ``gt_semantic_seg`` (B, H/8, W/8) int labels."""

    def stage_context(self, feats) -> dict:
        if not self.roi_head.semantic_fusion:
            return {}
        return dict(sem_embedding=self.roi_head.semantic_head(feats)[0])

    def forward_train(self, img, gt_bboxes, gt_labels, gt_valid,
                      gt_frame_masks, gt_semantic_seg=None
                      ) -> Dict[str, torch.Tensor]:
        head = self.roi_head
        feats = self.extract_feat(img)
        losses, proposals, prop_valid = self.train_proposals(
            feats, img, gt_bboxes, gt_labels, gt_valid)
        sem: Optional[torch.Tensor] = None
        if head.semantic_fusion:
            sem, sem_logits = head.semantic_head(feats)
            if gt_semantic_seg is not None:
                losses['loss_semantic_seg'] = head.semantic_loss(
                    sem_logits, gt_semantic_seg)
        gt_bboxes = torch.as_tensor(gt_bboxes).float()
        rois, sampled0, labels0, targets0, pos0 = head.sample_rois(
            proposals, prop_valid, gt_bboxes, gt_labels, gt_valid)
        img_shape = tuple(img.shape[1:3])
        prev = None
        for stage in range(head.num_stages):
            cls_logits, deltas = head.run_stage(stage, feats, rois, sampled0,
                                                sem_embedding=sem)
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
            gt_idx = max_iou_assign_batch(rois, gt_bboxes, gt_valid, 0.5,
                                          0.5, 0.5, True)
            mask_logits, prev = head.mask_stage(stage, feats, rois, sampled0,
                                                sem, prev)
            losses[f'loss_mask_s{stage}'] = w * head.mask_loss(
                stage, mask_logits, rois, pos, gt_idx, gt_bboxes,
                gt_frame_masks, labels)
            if stage < head.num_stages - 1:
                rois = head.refine(stage, rois, deltas.detach(), img_shape)
        losses['num_gts'] = (gt_valid.float().sum() / global_count(
            gt_valid.shape[0], gt_valid.device))
        return losses
