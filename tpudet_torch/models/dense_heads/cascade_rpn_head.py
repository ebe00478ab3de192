"""Cascade RPN: port of ``tpudet/models/dense_heads/cascade_rpn_head.py``
(``anchor_offsets``, ``StageCascadeRPN``, ``CascadeRPNHead``).

Two stages refine one square anchor a cell (``anchor_scale`` strides on a
side):

- stage 0: a 3x3 conv of dilation 3 (no bias, N(0, 0.01^2)), ReLU, then
  ``rpn_reg`` (1x1, 4 deltas); no classifier. Its deltas (stds 0.1, 0.1,
  0.5, 0.5) refine the anchors;
- stage 1: a deformable 3x3 conv (``ops/deform_conv.DeformConv2d``, no
  bias) on stage 0's features, one kernel for every level, sampled at
  ``anchor_offsets`` of the refined anchors (each tap's (y, x) offset:
  the anchor centre's from the cell, plus the tap scaled by the anchor's
  side over two strides, less one); ReLU, then ``rpn_cls`` (1 logit) and
  ``rpn_reg`` (4 deltas, stds 0.05, 0.05, 0.1, 0.1).

``loss`` (``:172-276``):

- stage 0, the region assignment: each gt belongs to the level of
  ``floor(log2(sqrt(area)) - log2(anchor_scale * stride_0) + 0.5)``
  (clipped to the levels); there its centre region (the middle 0.2 of the
  box in cells, rounded half to even, clipped to the map) claims cells,
  the highest gt index on an overlap. The claimed anchors' decoded boxes
  take the linear IoU loss to their gt, times 10, over the claimed count;
- stage 1: MaxIoU (0.7 / 0.7 / 0.3, low-quality matches) on the refined
  anchors, 256 sampled an image by numpy ``RandomState(7)``'s fixed
  priority, at most 128 positive (ties by index); the objectness BCE over
  the sampled count, and the linear IoU loss of the stage-1 decode times
  10 over the kept positives.

Every count is over every rank's batch (``global_sum``).

``get_proposals`` (``:279-323``): each level's refined anchors, clipped
to the canvas, and its top ``nms_pre`` by objectness (ties by index),
decoded by stage 1 and clipped; boxes of zero width or height are not
valid; one NMS of the batch with each level offset by ``level * (max
coord + 1)``, the max over the batch's valid boxes, keeps ``max_num``.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...core.anchors import AnchorGenerator
from ...core.assigners import NEGATIVE, max_iou_assign_batch, priority_rank
from ...core.bbox import DeltaXYWHBBoxCoder
from ...core.nms import _gather_rows, nms_padded, topk_scores
from ...ops.deform_conv import DeformConv2d
from ...parallel.mesh import global_sum
from ...registry import HEADS
from .. import losses as L
from ..layers import Conv
from .atss_head import flat, matched_boxes, no_dtype
from .rpn_head import fixed_priority

STAGE0_STDS = (0.1, 0.1, 0.5, 0.5)
STAGE1_STDS = (0.05, 0.05, 0.1, 0.1)


def anchor_offsets(anchors, stride: int, featmap_size, k: int = 3):
    """The deformable offsets of per-cell anchors (``cascade_rpn_head.py:
    42-66``): anchors (B, H*W, 4) -> (B, H, W, 2 k k), (y, x) a tap over
    the row-major taps."""
    h, w = featmap_size
    pad = (k - 1) // 2
    dev, dt = anchors.device, anchors.dtype
    idx = torch.arange(-pad, pad + 1, device=dev).to(dt)
    yy = idx.repeat_interleave(k)
    xx = idx.repeat(k)
    aw = (anchors[..., 2] - anchors[..., 0]) / stride
    ah = (anchors[..., 3] - anchors[..., 1]) / stride
    sx = (aw / (k - 1) - 1.0)[..., None] * xx
    sy = (ah / (k - 1) - 1.0)[..., None] * yy
    cx = (anchors[..., 0] + anchors[..., 2]) * 0.5 / stride
    cy = (anchors[..., 1] + anchors[..., 3]) * 0.5 / stride
    gx = torch.arange(w, device=dev).to(dt).repeat(h)
    gy = torch.arange(h, device=dev).to(dt).repeat_interleave(w)
    ox = sx + (cx - gx[None])[..., None]
    oy = sy + (cy - gy[None])[..., None]
    return torch.stack([oy, ox], -1).reshape(anchors.shape[0], h, w,
                                             2 * k * k)


class StageCascadeRPN(nn.Module):
    """One stage (``cascade_rpn_head.py:69-106``): ``adapt_type``
    ``'dilation'`` (a dilated conv) or ``'offset'`` (the deformable conv,
    offsets from the caller), then ``rpn_cls`` (with ``with_cls``) and
    ``rpn_reg``. ``forward(feats, offsets)`` takes NCHW levels (and
    (B, H, W, 18) offsets a level) and returns (bridged NCHW features,
    (B, H, W, 1) logits or None, (B, H, W, 4) deltas) a level."""

    def __init__(self, in_channels: int = 256, feat_channels: int = 256,
                 adapt_type: str = 'dilation', dilation: int = 3,
                 with_cls: bool = True):
        super().__init__()
        self.adapt_type = adapt_type
        normal = ('normal', 0.01)
        if adapt_type == 'offset':
            self.rpn_conv = DeformConv2d(in_channels, feat_channels, 3)
        else:
            self.rpn_conv = Conv(in_channels, feat_channels, 3, 1, dilation,
                                 dilation, bias=False, kernel_init=normal)
        self.rpn_cls = (Conv(feat_channels, 1, 1, kernel_init=normal)
                        if with_cls else None)
        self.rpn_reg = Conv(feat_channels, 4, 1, kernel_init=normal)

    def forward(self, feats, offsets=None):
        bridged, cls_out, reg_out = [], [], []
        for lvl, feat in enumerate(feats):
            if self.adapt_type == 'offset':
                x = F.relu(self.rpn_conv(
                    feat, offsets[lvl].permute(0, 3, 1, 2))).to(feat.dtype)
            else:
                x = F.relu(self.rpn_conv(feat))
            bridged.append(x)
            cls_out.append(None if self.rpn_cls is None else
                           self.rpn_cls(x).permute(0, 2, 3, 1))
            reg_out.append(self.rpn_reg(x).permute(0, 2, 3, 1))
        return bridged, tuple(cls_out), tuple(reg_out)


@HEADS.register_module()
class CascadeRPNHead(nn.Module):
    """The keyword arguments are tpudet's fields (``cascade_rpn_head.py:
    111-124``) with its defaults; ``ignore_ratio`` is taken and never read,
    as in tpudet (stage 0 has no classifier for its ignore regions,
    ``:221-223``)."""

    def __init__(self, in_channels: int = 256, feat_channels: int = 256,
                 strides: Sequence[int] = (4, 8, 16, 32, 64),
                 anchor_scale: int = 8, center_ratio: float = 0.2,
                 ignore_ratio: float = 0.5, pos_iou_thr: float = 0.7,
                 neg_iou_thr: float = 0.7, min_pos_iou: float = 0.3,
                 num_samples: int = 256, loss_bbox_weight: float = 10.0,
                 dtype=None):
        super().__init__()
        no_dtype('CascadeRPNHead', dtype)
        self.strides = tuple(strides)
        self.anchor_scale = anchor_scale
        self.center_ratio = center_ratio
        self.pos_iou_thr, self.neg_iou_thr = pos_iou_thr, neg_iou_thr
        self.min_pos_iou = min_pos_iou
        self.num_samples = num_samples
        self.loss_bbox_weight = loss_bbox_weight
        self.anchor_generator = AnchorGenerator(
            strides=list(self.strides), ratios=[1.0], scales=[anchor_scale])
        self.coder0 = DeltaXYWHBBoxCoder(target_stds=STAGE0_STDS)
        self.coder1 = DeltaXYWHBBoxCoder(target_stds=STAGE1_STDS)
        self.stage0 = StageCascadeRPN(in_channels, feat_channels,
                                      'dilation', with_cls=False)
        self.stage1 = StageCascadeRPN(feat_channels, feat_channels, 'offset',
                                      with_cls=True)
        self._cache: Dict = {}

    def _anchors(self, maps):
        """Per-level anchors of the maps' (H, W) sizes, their
        concatenation and the sample priority, on the maps' device
        (cached)."""
        sizes = tuple(tuple(m.shape[1:3]) for m in maps)
        dev = maps[0].device
        key = (sizes, dev)
        if key not in self._cache:
            levels = self.anchor_generator.grid_anchors(sizes)
            allv = np.concatenate(levels)
            self._cache[key] = ([torch.from_numpy(a).to(dev) for a in levels],
                                torch.from_numpy(allv).to(dev),
                                fixed_priority(len(allv), 7, dev))
        return self._cache[key]

    def _refine(self, anchors, reg, img_shape=None):
        """Stage 0's refined anchors, fp32, without gradient."""
        return self.coder0.decode(anchors, reg.float(),
                                  max_shape=img_shape).detach()

    def forward(self, feats):
        """NCHW levels -> (stage-0 deltas, stage-1 logits, stage-1 deltas),
        per-level (B, H, W, 4), (B, H, W, 1), (B, H, W, 4)."""
        b = feats[0].shape[0]
        x, _, reg0 = self.stage0(feats)
        levels, _, _ = self._anchors(reg0)
        offsets = []
        for lvl, anchors in enumerate(levels):
            refined = self._refine(anchors[None].expand(b, -1, -1),
                                   reg0[lvl].reshape(b, -1, 4))
            offsets.append(anchor_offsets(refined, self.strides[lvl],
                                          tuple(reg0[lvl].shape[1:3])))
        _, cls1, reg1 = self.stage1(x, offsets)
        return reg0, cls1, reg1

    def region_claims(self, featmap_sizes, gt_bboxes, gt_valid):
        """Stage 0's region assignment (``cascade_rpn_head.py:184-230``):
        (B, A) the gt index claiming each anchor, -1 for none."""
        num_lvls = len(featmap_sizes)
        scale = torch.sqrt(torch.clamp_min(
            (gt_bboxes[..., 2] - gt_bboxes[..., 0]) *
            (gt_bboxes[..., 3] - gt_bboxes[..., 1]), 1e-6))
        min_size = float(self.anchor_scale * self.strides[0])
        tgt_lvl = torch.clamp(torch.floor(
            torch.log2(scale) - math.log2(min_size) + 0.5), 0,
            num_lvls - 1).long()
        r1 = (1 - self.center_ratio) / 2
        b, n_gt = gt_valid.shape
        gidx = torch.arange(n_gt, dtype=torch.int32, device=gt_valid.device)
        parts = []
        for lvl, (h, w) in enumerate(featmap_sizes):
            g = gt_bboxes / self.strides[lvl]

            def side(lo, hi, n):
                return torch.clamp(torch.round((1 - r1) * lo + r1 * hi), 0,
                                   n - 1)
            x1, x2 = side(g[..., 0], g[..., 2], w), side(g[..., 2], g[..., 0],
                                                         w)
            y1, y2 = side(g[..., 1], g[..., 3], h), side(g[..., 3], g[..., 1],
                                                         h)
            xs = torch.arange(w, device=g.device).to(g.dtype)
            ys = torch.arange(h, device=g.device).to(g.dtype)
            in_x = (xs >= x1[..., None]) & (xs <= x2[..., None])  # B G W
            in_y = (ys >= y1[..., None]) & (ys <= y2[..., None])  # B G H
            own = gt_valid & (tgt_lvl == lvl)
            center = in_y[..., :, None] & in_x[..., None, :] & \
                own[..., None, None]  # (B, G, H, W)
            claim = torch.where(center, gidx[None, :, None, None],
                                gidx.new_full((), -1)).amax(dim=1)
            parts.append(claim.reshape(b, -1))
        return torch.cat(parts, dim=1).long()

    def loss(self, preds, gt_bboxes, gt_labels, gt_valid
             ) -> Dict[str, torch.Tensor]:
        """Stage 0's IoU loss, stage 1's objectness and IoU losses, in fp32
        (``cascade_rpn_head.py:172-276``). ``gt_labels`` is not read."""
        reg0, cls1, reg1 = preds
        _, anchors0, priority = self._anchors(reg0)
        b = reg0[0].shape[0]
        reg0_f = flat(reg0, b, 4).float()
        cls1_f = flat(cls1, b, 1).float()[..., 0]
        reg1_f = flat(reg1, b, 4).float()
        gt_bboxes = gt_bboxes.float()

        pos_gt = self.region_claims([tuple(r.shape[1:3]) for r in reg0],
                                    gt_bboxes, gt_valid)
        pos0 = pos_gt >= 0
        num_pos0 = torch.clamp_min(global_sum(pos0.float().sum()), 1.0)
        matched0 = matched_boxes(gt_bboxes, pos_gt.clamp_min(0))
        decoded0 = self.coder0.decode(anchors0[None], reg0_f)
        loss_reg0 = L.iou_loss(
            decoded0, torch.where(pos0[..., None], matched0, decoded0),
            weight=pos0.float(), avg_factor=num_pos0,
            loss_weight=self.loss_bbox_weight, linear=True)

        refined = self.coder0.decode(anchors0[None], reg0_f).detach()
        assigned = max_iou_assign_batch(refined, gt_bboxes, gt_valid,
                                        self.pos_iou_thr, self.neg_iou_thr,
                                        self.min_pos_iou, True)
        pos1 = assigned >= 0
        neg1 = assigned == NEGATIVE
        pos_k = pos1 & (priority_rank(pos1, priority) <
                        self.num_samples // 2)
        n_pos = pos_k.sum(dim=1, keepdim=True)
        neg_k = neg1 & (priority_rank(neg1, priority) <
                        self.num_samples - n_pos)
        sampled = pos_k | neg_k
        num_total = torch.clamp_min(global_sum(sampled.float().sum()), 1.0)
        bce = L.binary_cross_entropy_with_logits(cls1_f, pos_k.float())
        loss_cls1 = (bce * sampled).sum() / num_total

        matched1 = matched_boxes(gt_bboxes, assigned.clamp_min(0))
        decoded1 = self.coder1.decode(refined, reg1_f)
        num_pos1 = torch.clamp_min(global_sum(pos_k.float().sum()), 1.0)
        loss_reg1 = L.iou_loss(
            decoded1, torch.where(pos_k[..., None], matched1, decoded1),
            weight=pos_k.float(), avg_factor=num_pos1,
            loss_weight=self.loss_bbox_weight, linear=True)
        return dict(loss_rpn_reg_s0=loss_reg0, loss_rpn_cls=loss_cls1,
                    loss_rpn_bbox=loss_reg1)

    def get_proposals(self, preds, img_shape=None, nms_pre: int = 2000,
                      max_num: int = 300, iou_thr: float = 0.8,
                      min_bbox_size: float = 0.):
        """Proposals of the batch, in fp32: ``(proposals (B, max_num, 4),
        scores (B, max_num), valid (B, max_num))``, zero where not valid,
        in score order."""
        reg0, cls1, reg1 = preds
        levels, _, _ = self._anchors(reg0)
        b = reg0[0].shape[0]
        boxes_all, scores_all, level_all = [], [], []
        for lvl, anchors in enumerate(levels):
            refined = self._refine(anchors[None].expand(b, -1, -1),
                                   reg0[lvl].reshape(b, -1, 4), img_shape)
            scores = torch.sigmoid(cls1[lvl].reshape(b, -1).float())
            deltas = reg1[lvl].reshape(b, -1, 4).float()
            k = min(nms_pre, scores.shape[1])
            if 0 < k < scores.shape[1]:
                scores, topk = topk_scores(scores, k)
                deltas = _gather_rows(deltas, topk)
                refined = _gather_rows(refined, topk)
            boxes_all.append(self.coder1.decode(refined, deltas,
                                                max_shape=img_shape))
            scores_all.append(scores)
            level_all.append(torch.full(scores.shape, float(lvl),
                                        device=scores.device))
        boxes = torch.cat(boxes_all, dim=1)
        scores = torch.cat(scores_all, dim=1)
        lvls = torch.cat(level_all, dim=1)
        valid = ((boxes[..., 2] - boxes[..., 0] > min_bbox_size) &
                 (boxes[..., 3] - boxes[..., 1] > min_bbox_size))
        max_coord = torch.where(valid[..., None], boxes, 0.).max()
        keep_idx, keep_valid = nms_padded(
            boxes + (lvls * (max_coord + 1.))[..., None], scores, iou_thr,
            max_num, valid)
        props = torch.where(keep_valid[..., None],
                            _gather_rows(boxes, keep_idx), 0.)
        pscores = torch.where(keep_valid, torch.gather(scores, 1, keep_idx),
                              0.)
        return props, pscores, keep_valid
