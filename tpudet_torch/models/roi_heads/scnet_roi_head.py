"""SCNet: port of ``tpudet/models/roi_heads/scnet_roi_head.py``
(``SCNetBBoxHead``, ``GlobalContextHead``, ``SCNetMaskHead``,
``SCNetRoIHead``, ``SCNet``).

The Cascade R-CNN stages with three couplings:

- HTC's ``FusedSemanticHead``: its stride-8 embedding's RoIAlign crops are
  added to the 7 x 7 bbox and the 14 x 14 mask features
  (``loss_semantic_seg``: 0.2 x the mean CE against the one-hot labels, a
  label outside the classes a zero row, when ``gt_semantic_seg`` is
  given);
- ``GlobalContextHead``: four 3x3 convs with ReLU on the last pyramid
  level, the spatial mean (B, C), added to every roi's features, and an
  FC to multi-label class logits (``loss_glbctx``: 3.0 x the mean BCE
  against the classes each image holds);
- feature relay: the last stage's shared FC feature through
  ``feat_relay_fc`` to a 7 x 7 x C map, resized bilinearly to 14 x 14
  (``ops/resize.resize_bilinear``, jax's semantics) and added to the mask
  features.

``SCNetBBoxHead`` is the class-agnostic ``Shared2FCBBoxHead`` that also
returns its shared FC feature. One ``SCNetMaskHead`` (two residual blocks
of 3x3 convs, a 2x2 stride-2 transposed conv, the 1x1 logits) runs once
after the cascade, on the twice-refined rois (assigned at IoU 0.5), its
loss scaled by the sum of the stage weights (1.75). As in HTC, training
refines every slot, the gt-origin ones too. ``SCNet.predict_masks`` runs
the last stage on the detections for the relay feature: (B, D, 28, 28,
C) probabilities, the test flow's ``'roi'`` mode.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...core.assigners import max_iou_assign_batch
from ...ops.resize import resize_bilinear
from ...parallel.mesh import global_count, global_mean
from ...registry import DETECTORS, HEADS
from .. import losses as L
from ..layers import Conv, ConvTranspose, Dense
from .bbox_head import Shared2FCBBoxHead
from .cascade_roi_head import STAGE_WEIGHTS, CascadeRCNN, CascadeRoIHead
from .htc_roi_head import FusedSemanticHead, semantic_roi_feats
from .mask_head import MASK_ROI_SIZE, mask_bce_loss


class SCNetBBoxHead(Shared2FCBBoxHead):
    """``forward`` -> (class logits, deltas (..., 4), the shared FC
    feature)."""

    def __init__(self, num_classes: int, in_channels: int = 256,
                 roi_feat_size: int = 7, fc_out_channels: int = 1024):
        super().__init__(num_classes, in_channels, roi_feat_size,
                         fc_out_channels, reg_class_agnostic=True)

    def forward(self, roi_feats):
        x = roi_feats.reshape(roi_feats.shape[:-3] + (-1,))
        x = F.relu(self.shared_fc0(x))
        x = F.relu(self.shared_fc1(x))
        return self.fc_cls(x), self.fc_reg(x), x


class GlobalContextHead(nn.Module):
    """``forward(feats)`` -> (multi-label logits (B, num_classes) fp32,
    the pooled feature (B, C))."""

    def __init__(self, num_classes: int, in_channels: int = 256,
                 conv_out_channels: int = 256, num_convs: int = 4):
        super().__init__()
        self.num_convs = num_convs
        cin = in_channels
        for i in range(num_convs):
            self.add_module(f'conv{i}', Conv(cin, conv_out_channels, 3,
                                             padding=1))
            cin = conv_out_channels
        self.fc = Dense(cin, num_classes, kernel_init=('normal', 0.01))

    def forward(self, feats):
        x = feats[-1]
        for i in range(self.num_convs):
            x = F.relu(getattr(self, f'conv{i}')(x))
        pooled = x.mean(dim=(2, 3))
        return self.fc(pooled).float(), pooled


class SCNetMaskHead(nn.Module):
    """(N, 14, 14, C) -> (N, 28, 28, num_classes) logits: residual blocks
    (``res{i}_conv1``, ``res{i}_conv2``, a bias-free 1x1 ``res{i}_proj``
    where the channels change), the ReLU'd 2x2 stride-2 ``upsample``, the
    1x1 ``conv_logits`` N(0, 0.001^2)."""

    def __init__(self, num_classes: int, in_channels: int = 256,
                 conv_out_channels: int = 256, num_res_blocks: int = 2):
        super().__init__()
        self.num_res_blocks = num_res_blocks
        cin = in_channels
        for i in range(num_res_blocks):
            self.add_module(f'res{i}_conv1', Conv(cin, conv_out_channels, 3,
                                                  padding=1))
            self.add_module(f'res{i}_conv2', Conv(
                conv_out_channels, conv_out_channels, 3, padding=1))
            if cin != conv_out_channels:
                self.add_module(f'res{i}_proj', Conv(cin, conv_out_channels,
                                                     1, bias=False))
            cin = conv_out_channels
        self.upsample = ConvTranspose(cin, conv_out_channels, 2, stride=2)
        self.conv_logits = Conv(conv_out_channels, num_classes, 1,
                                kernel_init=('normal', 0.001))

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        for i in range(self.num_res_blocks):
            y = F.relu(getattr(self, f'res{i}_conv1')(x))
            y = getattr(self, f'res{i}_conv2')(y)
            proj = getattr(self, f'res{i}_proj', None)
            x = F.relu((x if proj is None else proj(x)) + y)
        x = F.relu(self.upsample(x))
        return self.conv_logits(x).permute(0, 2, 3, 1)


@HEADS.register_module()
class SCNetRoIHead(CascadeRoIHead):
    """``CascadeRoIHead``'s keyword arguments (its stage heads replaced by
    ``SCNetBBoxHead``s) and tpudet's fields ``mask_size``,
    ``num_semantic_classes``, ``semantic_stride``,
    ``semantic_loss_weight``, ``glbctx_loss_weight``,
    ``fc_out_channels``."""

    def __init__(self, num_classes: int, in_channels: int = 256,
                 mask_size: int = 28, num_semantic_classes: int = 183,
                 semantic_stride: int = 8,
                 semantic_loss_weight: float = 0.2,
                 glbctx_loss_weight: float = 3.0,
                 fc_out_channels: int = 1024, **kwargs):
        super().__init__(num_classes, in_channels=in_channels, **kwargs)
        self.mask_size = mask_size
        self.num_semantic_classes = num_semantic_classes
        self.semantic_stride = semantic_stride
        self.semantic_loss_weight = semantic_loss_weight
        self.glbctx_loss_weight = glbctx_loss_weight
        self.in_channels = in_channels
        for i in range(self.num_stages):
            self.add_module(f'bbox_head{i}', SCNetBBoxHead(
                num_classes, in_channels, self.roi_size, fc_out_channels))
        self.mask_head = SCNetMaskHead(num_classes, in_channels)
        self.semantic_head = FusedSemanticHead(
            num_semantic_classes, in_channels, in_channels)
        self.glbctx_head = GlobalContextHead(num_classes, in_channels,
                                             in_channels)
        self.feat_relay_fc = Dense(
            fc_out_channels, in_channels * self.roi_size * self.roi_size,
            kernel_init='he_normal')

    def run_stage(self, stage: int, feats, rois, roi_valid,
                  sem_embedding=None, glbctx_feat=None):
        """Pool, add the semantic crop and the global context, run the
        stage's head: (class logits, deltas, shared FC feature)."""
        pooled = self.extract(feats, rois, roi_valid)
        if sem_embedding is not None:
            pooled = pooled + semantic_roi_feats(
                sem_embedding, rois, self.semantic_stride, self.roi_size)
        if glbctx_feat is not None:
            pooled = pooled + glbctx_feat[:, None, None, None, :]
        return getattr(self, f'bbox_head{stage}')(pooled)

    def mask_forward(self, feats, rois, roi_valid, sem_embedding,
                     glbctx_feat, relayed):
        """(B, P, 28, 28, C) mask logits of 14 x 14 features with the
        semantic crop, the global context and the relayed feature
        added."""
        x = self.extract(feats, rois, roi_valid, out_size=MASK_ROI_SIZE)
        b, p = x.shape[:2]
        if sem_embedding is not None:
            x = x + semantic_roi_feats(sem_embedding, rois,
                                       self.semantic_stride, MASK_ROI_SIZE)
        if glbctx_feat is not None:
            x = x + glbctx_feat[:, None, None, None, :]
        if relayed is not None:
            r = self.feat_relay_fc(relayed).reshape(
                b, p, self.roi_size, self.roi_size, self.in_channels)
            x = x + resize_bilinear(r, (b, p, MASK_ROI_SIZE, MASK_ROI_SIZE,
                                        self.in_channels))
        logits = self.mask_head(x.reshape((b * p,) + x.shape[2:]))
        return logits.reshape((b, p) + logits.shape[1:])

    def semantic_loss(self, seg_logits, gt_semantic_seg
                      ) -> Dict[str, torch.Tensor]:
        """``semantic_loss_weight`` x the mean CE of the NCHW logits
        against the one-hot labels (a label outside the classes: a zero
        row, counted in the mean), over every rank's pixels."""
        logp = F.log_softmax(seg_logits, dim=1)
        classes = torch.arange(self.num_semantic_classes,
                               device=logp.device)[None, :, None, None]
        tgt = (gt_semantic_seg.long()[:, None] == classes).to(logp.dtype)
        return dict(loss_semantic_seg=self.semantic_loss_weight *
                    global_mean(-(tgt * logp).sum(dim=1)))

    def glbctx_loss(self, mc_pred, gt_labels, gt_valid
                    ) -> Dict[str, torch.Tensor]:
        """``glbctx_loss_weight`` x the mean BCE of the multi-label logits
        against each image's classes of valid gts, over every rank's
        images."""
        classes = torch.arange(self.num_classes, device=mc_pred.device)
        onehot = (gt_labels.long()[..., None] == classes).to(mc_pred.dtype)
        tgt = (onehot * gt_valid[..., None].to(mc_pred.dtype)).amax(dim=1)
        bce = L.binary_cross_entropy_with_logits(mc_pred, tgt)
        return dict(loss_glbctx=self.glbctx_loss_weight * global_mean(bce))


@DETECTORS.register_module()
class SCNet(CascadeRCNN):
    """``forward`` as ``CascadeRCNN``'s, each stage fed the semantic
    embedding and the global context; ``forward_train`` takes
    ``gt_frame_masks`` and, optionally, ``gt_semantic_seg``."""

    def context(self, feats):
        """(semantic embedding, semantic logits, multi-label logits,
        global context feature)."""
        sem, seg_logits = self.roi_head.semantic_head(feats)
        mc_pred, glbctx = self.roi_head.glbctx_head(feats)
        return sem, seg_logits, mc_pred, glbctx

    def stage_context(self, feats) -> dict:
        sem, _, _, glbctx = self.context(feats)
        return dict(sem_embedding=sem, glbctx_feat=glbctx)

    def forward_train(self, img, gt_bboxes, gt_labels, gt_valid,
                      gt_frame_masks, gt_semantic_seg=None
                      ) -> Dict[str, torch.Tensor]:
        head = self.roi_head
        feats = self.extract_feat(img)
        sem, seg_logits, mc_pred, glbctx = self.context(feats)
        losses, proposals, prop_valid = self.train_proposals(
            feats, img, gt_bboxes, gt_labels, gt_valid)
        if gt_semantic_seg is not None:
            losses.update(head.semantic_loss(seg_logits, gt_semantic_seg))
        losses.update(head.glbctx_loss(mc_pred, gt_labels, gt_valid))
        gt_bboxes = torch.as_tensor(gt_bboxes).float()
        rois, sampled0, labels0, targets0, pos0 = head.sample_rois(
            proposals, prop_valid, gt_bboxes, gt_labels, gt_valid)
        img_shape = tuple(img.shape[1:3])
        relayed: Optional[torch.Tensor] = None
        for stage in range(head.num_stages):
            cls_logits, deltas, relayed = head.run_stage(
                stage, feats, rois, sampled0, sem_embedding=sem,
                glbctx_feat=glbctx)
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
                rois = head.refine(stage, rois, deltas.detach(), img_shape)
        gt_idx = max_iou_assign_batch(rois, gt_bboxes, gt_valid, 0.5, 0.5,
                                      0.5, True)
        m_labels = torch.where(
            pos, torch.gather(gt_labels.long(), 1, gt_idx.clamp_min(0)),
            head.num_classes)
        mask_logits = head.mask_forward(feats, rois, sampled0, sem, glbctx,
                                        relayed)
        losses['loss_mask'] = float(sum(STAGE_WEIGHTS)) * mask_bce_loss(
            mask_logits, rois, pos, gt_idx, gt_bboxes, gt_frame_masks,
            m_labels, head.num_classes, head.mask_size)
        losses['num_gts'] = (gt_valid.float().sum() / global_count(
            gt_valid.shape[0], gt_valid.device))
        return losses

    def predict_masks(self, img, det_bboxes, det_valid,
                      feats: Optional[list] = None) -> torch.Tensor:
        """(B, D, 28, 28, C) mask probabilities of detections (network
        input frame), the last stage run on them for the relay feature;
        ``feats`` of the same call are reused where given."""
        if feats is None:
            feats = self.extract_feat(img)
        head = self.roi_head
        sem, _, _, glbctx = self.context(feats)
        _, _, shared = head.run_stage(head.num_stages - 1, feats, det_bboxes,
                                      det_valid, sem_embedding=sem,
                                      glbctx_feat=glbctx)
        return torch.sigmoid(head.mask_forward(feats, det_bboxes, det_valid,
                                               sem, glbctx, shared))
