"""Guided anchoring: port of ``tpudet/models/dense_heads/
guided_anchor_head.py`` (``FeatureAdaption``, ``GARetinaHead``,
``GARPNHead``).

Per cell the head predicts a location logit (``conv_loc``, 1x1, the 0.01
prior bias), an anchor shape (``conv_shape``, 1x1: log-scales of the
cell's square anchor's width and height, clipped at +-10), and class and
box outputs on features adapted to that shape: ``FeatureAdaption`` maps
the detached shape through a bias-free 1x1 conv (N(0, 0.1^2)) to the
offsets of a v1 deformable 3x3 (``ops/deform_conv.DeformConv2d``, fp32),
then ReLU. The guided anchors (square, shape applied, same centre) are
the anchor set of the class and box targets and of the decode.

``GARetinaHead``: RetinaNet's towers (``cls_conv{i}``, ``reg_conv{i}``),
``conv_loc`` on the class tower, ``conv_shape`` on the box tower, one
adaption each, ``retina_cls`` (C, prior bias) and ``retina_reg`` (4)
3x3s; every conv N(0, 0.01^2). ``GARPNHead``: one shared ``rpn_conv``
with ReLU, then ``conv_loc``, ``conv_shape``, one ``feature_adaption`` and
1x1 ``rpn_cls`` / ``rpn_reg``. Pred maps leave the head as (cls, reg,
shape, loc) per-level (B, H, W, attrib) tuples.

``loss`` (``guided_anchor_head.py:234-350``; the RPN's ``:431-532``):

- location: ``loc_targets``' dense centre (ratio 0.2), ignore (0.5) and
  negative maps, each gt on the level of its scale and ignoring its
  region on the adjacent levels; a later gt's ignore ring overwrites an
  earlier gt's centre (last-writer ranks); the focal loss summed over
  every cell with weights 1 / 0 / 0.1 and divided by ``b * cells / 200``
  (``b`` summed over the ranks). Its binary target is ``1 - centre``:
  tpudet copies the mmdet label convention where a 1-channel FocalLoss
  treats label 0 as the positive class (``:253-266``), and so does the
  port;
- shape: the approx-max-IoU assignment over the 3 x 3 approx anchors
  (0.5 / 0.4, no low-quality matching; ``core/assigners.
  approx_max_iou_assign_batch``), the bounded IoU loss (beta 0.2) of the
  guided anchors against their gts summed over the positives and divided
  by the sampler's capped fg + bg count (at most 128 + 256 an image);
- RetinaNet: MaxIoU over the detached guided anchors, the focal loss and
  the smooth L1 (beta 0.04) of the deltas over ``num_pos``;
- the RPN: MaxIoU (0.7 / 0.3 / 0.3), then tpudet's fixed sample of 256
  anchors an image, at most 128 positive, by numpy
  ``RandomState(11).rand(A)`` priorities (the positives, then the
  negatives, of lowest priority, ties by index): the BCE over the sample,
  the smooth L1 (beta 1/9) over its positives.

Every count that divides a loss is summed over the ranks.

``get_bboxes`` (GARetinaHead, ``:361-406``): sigmoid scores zeroed where
the location probability is under ``loc_filter_thr``, the top ``nms_pre``
cells of each level by their best class (ties by index), the deltas
decoded on the guided anchors, then ``batched_nms``. ``get_proposals``
(GARPNHead, ``:534-581``): the same filter, the top ``nms_pre`` of each
level, the decode clipped to ``img_shape``, boxes kept where wider and
taller than ``min_bbox_size`` with a score above 0, one level-offset
``nms_padded`` an image to ``max_num``.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...core.anchors import AnchorGenerator
from ...core.assigners import (NEGATIVE, approx_max_iou_assign_batch,
                               max_iou_assign_batch, priority_rank)
from ...core.bbox import DeltaXYWHBBoxCoder
from ...core.nms import _gather_rows, batched_nms, nms_padded, topk_scores
from ...ops.deform_conv import DeformConv2d
from ...parallel.mesh import global_count, global_sum
from ...registry import HEADS
from .. import losses as L
from ..layers import Conv
from .atss_head import PRIOR_BIAS, flat, matched_boxes, no_dtype, num_gts
from .rpn_head import fixed_priority
from .sabl_retina_head import SquareAnchors


def _conv(cin, cout, k, bias_init=0., bias=True, std=0.01):
    return Conv(cin, cout, k, 1, k // 2, bias=bias,
                kernel_init=('normal', std), bias_init=bias_init)


class FeatureAdaption(nn.Module):
    """``conv_offset`` (1x1, no bias, N(0, 0.1^2)) of the detached shape
    prediction gives the offsets of ``conv_adaption`` (v1 deformable,
    ``kernel_size``, no bias); ReLU. Returns the input's dtype
    (``guided_anchor_head.py:47-65``; tpudet's next conv casts the fp32
    sampling to its own)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3):
        super().__init__()
        k = kernel_size
        self.conv_offset = _conv(2, 2 * k * k, 1, bias=False, std=0.1)
        self.conv_adaption = DeformConv2d(in_channels, out_channels, k)

    def forward(self, x, shape_pred):
        offsets = self.conv_offset(shape_pred.detach())
        return F.relu(self.conv_adaption(x, offsets)).to(x.dtype)


def decode_shape(squares, shape_deltas):
    """Squares (..., 4) and (dw, dh) log-scales -> guided anchors, same
    centre (``guided_anchor_head.py:303-314``)."""
    cx = (squares[..., 0] + squares[..., 2]) * 0.5
    cy = (squares[..., 1] + squares[..., 3]) * 0.5
    w = squares[..., 2] - squares[..., 0]
    h = squares[..., 3] - squares[..., 1]
    nw = w * torch.exp(torch.clamp(shape_deltas[..., 0], -10., 10.))
    nh = h * torch.exp(torch.clamp(shape_deltas[..., 1], -10., 10.))
    return torch.stack([cx - nw / 2, cy - nh / 2, cx + nw / 2, cy + nh / 2],
                       dim=-1)


@HEADS.register_module()
class GARetinaHead(nn.Module):
    """The keyword arguments are tpudet's fields
    (``guided_anchor_head.py:70-96``) with its defaults."""

    def __init__(self, num_classes: int, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 strides: Sequence[int] = (8, 16, 32, 64, 128),
                 octave_base_scale: int = 4, scales_per_octave: int = 3,
                 ratios: Sequence[float] = (0.5, 1.0, 2.0),
                 loc_filter_thr: float = 0.01, center_ratio: float = 0.2,
                 ignore_ratio: float = 0.5, ga_sample_num: int = 256,
                 ga_pos_iou_thr: float = 0.5, ga_neg_iou_thr: float = 0.4,
                 pos_iou_thr: float = 0.5, neg_iou_thr: float = 0.5,
                 min_pos_iou: float = 0.0, focal_gamma: float = 2.0,
                 focal_alpha: float = 0.25, loss_shape_beta: float = 0.2,
                 loss_bbox_beta: float = 0.04, dtype=None):
        super().__init__()
        no_dtype(type(self).__name__, dtype)
        self.num_classes = num_classes
        self.strides = tuple(strides)
        self.octave_base_scale = octave_base_scale
        self.loc_filter_thr = loc_filter_thr
        self.center_ratio = center_ratio
        self.ignore_ratio = ignore_ratio
        self.ga_sample_num = ga_sample_num
        self.ga_pos_iou_thr = ga_pos_iou_thr
        self.ga_neg_iou_thr = ga_neg_iou_thr
        self.pos_iou_thr = pos_iou_thr
        self.neg_iou_thr = neg_iou_thr
        self.min_pos_iou = min_pos_iou
        self.focal_gamma = focal_gamma
        self.focal_alpha = focal_alpha
        self.loss_shape_beta = loss_shape_beta
        self.loss_bbox_beta = loss_bbox_beta
        self.bbox_coder = DeltaXYWHBBoxCoder()
        self.anchors = SquareAnchors(
            AnchorGenerator(strides=list(self.strides), ratios=[1.0],
                            scales=[octave_base_scale]),
            AnchorGenerator(strides=list(self.strides), ratios=list(ratios),
                            octave_base_scale=octave_base_scale,
                            scales_per_octave=scales_per_octave))
        self.stacked_convs = stacked_convs
        self.build_layers(in_channels, feat_channels)

    def build_layers(self, in_channels, feat_channels):
        for branch in ('cls', 'reg'):
            cin = in_channels
            for i in range(self.stacked_convs):
                self.add_module(f'{branch}_conv{i}', _conv(cin, feat_channels,
                                                           3))
                cin = feat_channels
        self.conv_loc = _conv(feat_channels, 1, 1, bias_init=PRIOR_BIAS)
        self.conv_shape = _conv(feat_channels, 2, 1)
        self.feature_adaption_cls = FeatureAdaption(feat_channels,
                                                    feat_channels)
        self.feature_adaption_reg = FeatureAdaption(feat_channels,
                                                    feat_channels)
        self.retina_cls = _conv(feat_channels, self.num_classes, 3,
                                bias_init=PRIOR_BIAS)
        self.retina_reg = _conv(feat_channels, 4, 3)

    def forward(self, feats):
        """NCHW features -> per-level (B, H, W, C) class logits, (B, H, W,
        4) deltas, (B, H, W, 2) shapes and (B, H, W, 1) location
        logits."""
        outs = ([], [], [], [])
        for feat in feats:
            c = r = feat
            for i in range(self.stacked_convs):
                c = F.relu(getattr(self, f'cls_conv{i}')(c))
                r = F.relu(getattr(self, f'reg_conv{i}')(r))
            loc = self.conv_loc(c)
            shape = self.conv_shape(r)
            cls = self.retina_cls(self.feature_adaption_cls(c, shape))
            reg = self.retina_reg(self.feature_adaption_reg(r, shape))
            for out, m in zip(outs, (cls, reg, shape, loc)):
                out.append(m.permute(0, 2, 3, 1))
        return tuple(tuple(o) for o in outs)

    # ------------------------------------------------------------------
    def loc_targets(self, featmap_sizes, gt_bboxes, gt_valid):
        """Dense centre / ignore / negative maps (``guided_anchor_head.py:
        169-232``): per level ``(targets (B, H, W), weights (B, H, W))``,
        and the average factor ``b * cells / 200``, ``b`` summed over the
        ranks."""
        num_lvls = len(featmap_sizes)
        r1 = (1 - self.center_ratio) / 2
        r2 = (1 - self.ignore_ratio) / 2
        scale = torch.sqrt(torch.clamp_min(
            (gt_bboxes[..., 2] - gt_bboxes[..., 0]) *
            (gt_bboxes[..., 3] - gt_bboxes[..., 1]), 1e-6))
        min_size = float(self.octave_base_scale * self.strides[0])
        tgt_lvl = torch.clamp(torch.floor(
            torch.log2(scale) - math.log2(min_size) + 0.5), 0,
            num_lvls - 1).to(torch.int32)  # (B, G)
        g = gt_bboxes.shape[1]
        gt_rank = torch.arange(1, g + 1, dtype=torch.int32,
                               device=gt_bboxes.device)[None, :, None, None]
        zero = gt_rank.new_zeros(())

        def region(h, w, stride, ratio, active):
            """(B, G, H, W) cells inside each active gt's ratio-region."""
            b = gt_bboxes / stride
            x1 = torch.round((1 - ratio) * b[..., 0] + ratio * b[..., 2])
            y1 = torch.round((1 - ratio) * b[..., 1] + ratio * b[..., 3])
            x2 = torch.round(ratio * b[..., 0] + (1 - ratio) * b[..., 2])
            y2 = torch.round(ratio * b[..., 1] + (1 - ratio) * b[..., 3])
            xs = torch.arange(w, dtype=torch.float32, device=b.device)
            ys = torch.arange(h, dtype=torch.float32, device=b.device)
            in_x = ((xs >= x1.clamp(0, w - 1)[..., None]) &
                    (xs <= x2.clamp(0, w - 1)[..., None]))
            in_y = ((ys >= y1.clamp(0, h - 1)[..., None]) &
                    (ys <= y2.clamp(0, h - 1)[..., None]))
            return (in_y[..., :, None] & in_x[..., None, :] &
                    active[..., None, None])

        out, total_cells = [], 0
        for lvl, (h, w) in enumerate(featmap_sizes):
            s = self.strides[lvl]
            total_cells += h * w
            own = gt_valid & (tgt_lvl == lvl)
            center = region(h, w, s, r1, own)
            ignore = region(h, w, s, r2, own)
            adj = gt_valid & ((tgt_lvl == lvl - 1) | (tgt_lvl == lvl + 1))
            adj_ignore = region(h, w, s, r2, adj).any(dim=1)
            targets = center.any(dim=1).to(gt_bboxes.dtype)
            # tpudet paints each gt in order (its ignore ring at 0, then its
            # centre at 1): a later gt's ring zeroes an earlier gt's centre;
            # the last writer of a cell is the highest rank there
            c_rank = torch.where(center, gt_rank, zero).amax(dim=1)
            i_rank = torch.where(ignore, gt_rank, zero).amax(dim=1)
            one, zero, negative = (targets.new_tensor(v)
                                   for v in (1.0, 0.0, 0.1))
            weights = torch.where(
                (c_rank > 0) & (c_rank >= i_rank), one,
                torch.where((i_rank > 0) | adj_ignore, zero, negative))
            out.append((targets, weights))
        b = global_count(gt_bboxes.shape[0], gt_bboxes.device)
        return out, b * total_cells / 200.0

    def _loc_loss(self, loc_preds, gt_bboxes, gt_valid):
        sizes = [tuple(x.shape[1:3]) for x in loc_preds]
        maps, loc_avg = self.loc_targets(sizes, gt_bboxes, gt_valid)
        loss = 0.
        for loc, (tgt, wgt) in zip(loc_preds, maps):
            # the focal loss's binary target is 1 - centre (tpudet's mmdet
            # label convention, ROADMAP.md §3)
            loss = loss + L.sigmoid_focal_loss(
                loc.float(), (1.0 - tgt)[..., None],
                gamma=self.focal_gamma, alpha=self.focal_alpha,
                weight=wgt[..., None], reduction='sum') / loc_avg
        return loss

    def _shape_loss(self, squares, approx, shape_flat, gt_bboxes, gt_valid):
        """The bounded IoU loss of the guided anchors over the approx
        assignment's positives; returns (loss, guided anchors)."""
        assigned = approx_max_iou_assign_batch(
            approx, gt_bboxes, gt_valid, self.ga_pos_iou_thr,
            self.ga_neg_iou_thr, match_low_quality=False)
        pos = assigned >= 0
        sq = squares[None].expand(pos.shape[0], -1, -1)
        matched = torch.where(pos[..., None],
                              matched_boxes(gt_bboxes, assigned.clamp_min(0)),
                              sq)
        pred_anchors = decode_shape(squares[None], shape_flat)
        fg = torch.clamp_max(pos.float().sum(1), self.ga_sample_num / 2)
        bg = torch.minimum((assigned == NEGATIVE).float().sum(1),
                           self.ga_sample_num - fg)
        total = torch.clamp_min(global_sum((fg + bg).sum()), 1.0)
        loss = L.bounded_iou_loss(pred_anchors, matched,
                                  beta=self.loss_shape_beta,
                                  weight=pos[..., None].float(),
                                  reduction='sum') / total
        return loss, pred_anchors

    def loss(self, preds, gt_bboxes, gt_labels, gt_valid
             ) -> Dict[str, torch.Tensor]:
        cls_scores, bbox_preds, shape_preds, loc_preds = preds
        _, squares, approx = self.anchors(cls_scores)
        b, nc = cls_scores[0].shape[0], self.num_classes
        gt_bboxes = gt_bboxes.float()
        loss_loc = self._loc_loss(loc_preds, gt_bboxes, gt_valid)
        loss_shape, pred_anchors = self._shape_loss(
            squares, approx, flat([s.float() for s in shape_preds], b, 2),
            gt_bboxes, gt_valid)
        guided = pred_anchors.detach()
        assigned = max_iou_assign_batch(guided, gt_bboxes, gt_valid,
                                        self.pos_iou_thr, self.neg_iou_thr,
                                        self.min_pos_iou, True)
        pos = assigned >= 0
        neg = assigned == NEGATIVE
        num_pos = torch.clamp_min(global_sum(pos.float().sum()), 1.0)
        gt_idx = assigned.clamp_min(0)
        labels = torch.gather(gt_labels.long(), 1, gt_idx)
        onehot = L.one_hot(labels, nc, torch.float32) * pos[..., None]
        loss_cls = L.sigmoid_focal_loss(
            flat([c.float() for c in cls_scores], b, nc), onehot,
            gamma=self.focal_gamma, alpha=self.focal_alpha,
            weight=(pos | neg).float()[..., None], avg_factor=num_pos)
        matched = torch.where(pos[..., None],
                              matched_boxes(gt_bboxes, gt_idx), guided)
        loss_bbox = L.smooth_l1_loss(
            flat([r.float() for r in bbox_preds], b, 4),
            self.bbox_coder.encode(guided, matched),
            beta=self.loss_bbox_beta, weight=pos[..., None].float(),
            avg_factor=num_pos)
        return dict(loss_loc=loss_loc, loss_shape=loss_shape,
                    loss_cls=loss_cls, loss_bbox=loss_bbox,
                    num_gts=num_gts(gt_valid))

    def _level_candidates(self, lvl, preds, squares, b):
        """One level's scores (B, n, C) zeroed under the location filter,
        deltas (B, n, 4) and guided anchors (B, n, 4)."""
        cls_scores, bbox_preds, shape_preds, loc_preds = preds
        scores = torch.sigmoid(cls_scores[lvl].reshape(
            b, -1, cls_scores[lvl].shape[-1]).float())
        loc = torch.sigmoid(loc_preds[lvl].reshape(b, -1).float())
        scores = scores * (loc >= self.loc_filter_thr)[..., None]
        guided = decode_shape(squares[None], shape_preds[lvl].reshape(
            b, -1, 2).float())
        return scores, bbox_preds[lvl].reshape(b, -1, 4).float(), guided

    def get_bboxes(self, preds, scale_factors=None, score_thr: float = 0.05,
                   iou_thr: float = 0.5, max_per_img: int = 100,
                   nms_pre: int = 1000, **kwargs):
        """Decode and NMS (``guided_anchor_head.py:361-406``); like
        tpudet's, no clip to the image and no raw path."""
        levels, _, _ = self.anchors(preds[0])
        b, nc = preds[0][0].shape[0], self.num_classes
        all_boxes, all_scores = [], []
        for lvl, squares in enumerate(levels):
            scores, deltas, guided = self._level_candidates(lvl, preds,
                                                            squares, b)
            k = min(nms_pre, scores.shape[1])
            if 0 < k < scores.shape[1]:
                _, idx = topk_scores(scores.amax(dim=-1), k)
                scores = _gather_rows(scores, idx)
                deltas = _gather_rows(deltas, idx)
                guided = _gather_rows(guided, idx)
            all_boxes.append(self.bbox_coder.decode(guided, deltas))
            all_scores.append(scores)
        bbox = torch.cat(all_boxes, dim=1)
        scores = torch.cat(all_scores, dim=1)
        if scale_factors is not None:
            bbox = bbox / torch.as_tensor(scale_factors, dtype=bbox.dtype,
                                          device=bbox.device)[:, None, :]
        return batched_nms(bbox, scores, score_thr, iou_thr, max_per_img,
                           nms_pre=min(4096, bbox.shape[1] * nc))


@HEADS.register_module()
class GARPNHead(GARetinaHead):
    """``GARetinaHead``'s keyword arguments with the RPN's defaults
    (``guided_anchor_head.py:409-423``): one class, strides 4-64, squares
    of 8 strides, MaxIoU 0.7 / 0.3 / 0.3."""

    SAMPLES, MAX_POS, PRIORITY_SEED = 256, 128, 11

    def __init__(self, num_classes: int = 1, in_channels: int = 256,
                 feat_channels: int = 256,
                 strides: Sequence[int] = (4, 8, 16, 32, 64),
                 octave_base_scale: int = 8, pos_iou_thr: float = 0.7,
                 neg_iou_thr: float = 0.3, min_pos_iou: float = 0.3,
                 **kwargs):
        super().__init__(num_classes, in_channels, feat_channels,
                         strides=strides,
                         octave_base_scale=octave_base_scale,
                         pos_iou_thr=pos_iou_thr, neg_iou_thr=neg_iou_thr,
                         min_pos_iou=min_pos_iou, **kwargs)
        self._priority: Dict = {}

    def build_layers(self, in_channels, feat_channels):
        self.rpn_conv = _conv(in_channels, feat_channels, 3)
        self.conv_loc = _conv(feat_channels, 1, 1, bias_init=PRIOR_BIAS)
        self.conv_shape = _conv(feat_channels, 2, 1)
        self.feature_adaption = FeatureAdaption(feat_channels, feat_channels)
        self.rpn_cls = _conv(feat_channels, 1, 1)
        self.rpn_reg = _conv(feat_channels, 4, 1)

    def forward(self, feats):
        outs = ([], [], [], [])
        for feat in feats:
            x = F.relu(self.rpn_conv(feat))
            loc = self.conv_loc(x)
            shape = self.conv_shape(x)
            a = self.feature_adaption(x, shape)
            for out, m in zip(outs, (self.rpn_cls(a), self.rpn_reg(a), shape,
                                     loc)):
                out.append(m.permute(0, 2, 3, 1))
        return tuple(tuple(o) for o in outs)

    def loss(self, preds, gt_bboxes, gt_labels, gt_valid
             ) -> Dict[str, torch.Tensor]:
        """The location and shape losses, then the objectness BCE and the
        deltas' smooth L1 on tpudet's fixed sample. ``gt_labels`` is not
        read."""
        cls_scores, bbox_preds, shape_preds, loc_preds = preds
        _, squares, approx = self.anchors(cls_scores)
        b = cls_scores[0].shape[0]
        gt_bboxes = gt_bboxes.float()
        loss_loc = self._loc_loss(loc_preds, gt_bboxes, gt_valid)
        loss_shape, pred_anchors = self._shape_loss(
            squares, approx, flat([s.float() for s in shape_preds], b, 2),
            gt_bboxes, gt_valid)
        guided = pred_anchors.detach()
        assigned = max_iou_assign_batch(guided, gt_bboxes, gt_valid,
                                        self.pos_iou_thr, self.neg_iou_thr,
                                        self.min_pos_iou, True)
        key = (len(squares), squares.device)
        if key not in self._priority:
            self._priority[key] = fixed_priority(len(squares),
                                                 self.PRIORITY_SEED,
                                                 squares.device)
        priority = self._priority[key]
        pos = (assigned >= 0) & (priority_rank(assigned >= 0, priority) <
                                 self.MAX_POS)
        neg = assigned == NEGATIVE
        neg = neg & (priority_rank(neg, priority) <
                     self.SAMPLES - pos.sum(dim=1, keepdim=True))
        sampled = pos | neg
        num = torch.clamp_min(global_sum(sampled.float().sum()), 1.0)
        num_pos = torch.clamp_min(global_sum(pos.float().sum()), 1.0)
        cls_flat = flat([c.float() for c in cls_scores], b, 1)[..., 0]
        loss_cls = (L.binary_cross_entropy_with_logits(
            cls_flat, pos.float()) * sampled).sum() / num
        matched = torch.where(
            pos[..., None], matched_boxes(gt_bboxes, assigned.clamp_min(0)),
            guided)
        loss_bbox = L.smooth_l1_loss(
            flat([r.float() for r in bbox_preds], b, 4),
            self.bbox_coder.encode(guided, matched), beta=1.0 / 9.0,
            weight=pos[..., None].float(), avg_factor=num_pos)
        return dict(loss_rpn_loc=loss_loc, loss_rpn_shape=loss_shape,
                    loss_rpn_cls=loss_cls, loss_rpn_bbox=loss_bbox)

    def get_proposals(self, preds, img_shape=None, nms_pre: int = 1000,
                      max_num: int = 300, iou_thr: float = 0.7,
                      min_bbox_size: float = 0.):
        """Proposals of the batch (``guided_anchor_head.py:534-581``):
        ``(proposals (B, max_num, 4), scores, valid)``, zero where not
        valid, in score order."""
        levels, _, _ = self.anchors(preds[0])
        b = preds[0][0].shape[0]
        boxes_all, scores_all, level_all = [], [], []
        for lvl, squares in enumerate(levels):
            scores, deltas, guided = self._level_candidates(lvl, preds,
                                                            squares, b)
            scores = scores[..., 0]
            k = min(nms_pre, scores.shape[1])
            if 0 < k < scores.shape[1]:
                scores, idx = topk_scores(scores, k)
                deltas = _gather_rows(deltas, idx)
                guided = _gather_rows(guided, idx)
            boxes_all.append(self.bbox_coder.decode(guided, deltas,
                                                    max_shape=img_shape))
            scores_all.append(scores)
            level_all.append(torch.full(scores.shape, float(lvl),
                                        device=scores.device))
        boxes = torch.cat(boxes_all, dim=1)
        scores = torch.cat(scores_all, dim=1)
        lvls = torch.cat(level_all, dim=1)
        valid = ((boxes[..., 2] - boxes[..., 0] > min_bbox_size) &
                 (boxes[..., 3] - boxes[..., 1] > min_bbox_size) &
                 (scores > 0))
        max_coord = torch.where(valid[..., None], boxes, 0.).max()
        keep_idx, keep_valid = nms_padded(
            boxes + (lvls * (max_coord + 1.))[..., None], scores, iou_thr,
            max_num, valid)
        return (torch.where(keep_valid[..., None],
                            _gather_rows(boxes, keep_idx), 0.),
                torch.where(keep_valid, torch.gather(scores, 1, keep_idx), 0.),
                keep_valid)
