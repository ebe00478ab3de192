"""VarifocalNet head: port of ``tpudet/models/dense_heads/vfnet_head.py``.

Towers of 3x3 conv (no bias) + flax ``GroupNorm(32)`` (eps 1e-6) + ReLU
(``cls{i}_conv`` / ``cls{i}_gn``, ``reg{i}_*``: flax's flat names, the
modules on the head itself), then on the regression
tower ``vfnet_reg_conv`` (the same block) and ``vfnet_reg``: the initial
side distances ``exp(scales[lvl] * conv) * reg_denom`` (64, 128, ..., in
fp32). The nine taps of the star-shaped deformable convs sit on that box's
corners, edge midpoints and centre: offsets (B, 18, H, W), y first, from
the distances in strides through ``gradient_mul`` 0.1, ``(1 - g)
detach(d) + g d``, less the 3x3 grid's own offsets. ``refine_dcn`` and
``cls_dcn`` (``ops/deform_conv.DeformConv2d``, sampling in fp32; their
ReLU outputs back in the tower's dtype) feed ``vfnet_reg_refine`` (refined
distances ``exp(scales_refine[lvl] * conv)`` times the detached initial
ones) and ``vfnet_cls`` (the 0.01 prior bias). Every conv N(0, 0.01^2).

Points sit at ``(x, y) * stride`` (centre offset 0); ATSS assigns over
square anchors ``anchor_scale`` strides wide around them.

``loss``: GIoU of the initial and of the refined boxes to the positives'
gts, each weighted by its own detached IoU (clamped at 1e-6) over their
sum clamped at 1; the varifocal loss to the refined IoU at the gt's class,
over ``max(num_pos, 1)``. Every denominator counts every rank's batch.

``get_bboxes``: the top ``nms_pre`` of each level by the best class
probability, the refined distances decoded from the points and clipped to
``img_shape``, then ``batched_nms`` of the top 2048 (box, class) pairs.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...core.assigners import atss_assign_batch
from ...core.bbox import _clip_to, bbox_overlaps_aligned
from ...ops.deform_conv import DeformConv2d
from ...parallel.mesh import global_sum
from ...registry import HEADS
from .. import losses as L
from ..plugins import GroupNorm
from .atss_head import (PRIOR_BIAS, finish_bboxes, flat, head_conv,
                        matched_boxes, no_dtype, num_gts, scaled, topk_levels)
from .gfl_head import distance_boxes

INF = 1e8
GN_GROUPS, GN_EPS = 32, 1e-6  # flax's nn.GroupNorm defaults


# the 3x3 grid's own (y, x) tap offsets, y first, taps row-major
STAR_BASE = [float(v) for v in np.stack([np.repeat([-1, 0, 1], 3),
                                         np.tile([-1, 0, 1], 3)],
                                        1).reshape(-1)]


@HEADS.register_module()
class VFNetHead(nn.Module):
    """The keyword arguments are tpudet's fields (``vfnet_head.py:34-52``)
    with its defaults. ``scales`` and ``scales_refine`` are its raw leaves
    (ones)."""

    flax_leaves = {'scales': ('scales', ''),
                   'scales_refine': ('scales_refine', '')}
    leaf_init = {'scales': 1.0, 'scales_refine': 1.0}

    def __init__(self, num_classes: int, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 3,
                 strides: Sequence[int] = (8, 16, 32, 64, 128),
                 regress_ranges: Sequence = ((-1, 64), (64, 128), (128, 256),
                                             (256, 512), (512, INF)),
                 gradient_mul: float = 0.1, atss_topk: int = 9,
                 anchor_scale: int = 8, vfl_alpha: float = 0.75,
                 vfl_gamma: float = 2.0, loss_cls_weight: float = 1.0,
                 loss_bbox_weight: float = 1.5,
                 loss_refine_weight: float = 2.0, dtype=None):
        super().__init__()
        no_dtype('VFNetHead', dtype)
        self.num_classes = num_classes
        self.strides = tuple(strides)
        denoms = [r[1] for r in regress_ranges[:-1]]
        self.reg_denoms = denoms + [denoms[-1] * 2]
        self.gradient_mul = gradient_mul
        self.atss_topk = atss_topk
        self.anchor_scale = anchor_scale
        self.vfl_alpha = vfl_alpha
        self.vfl_gamma = vfl_gamma
        self.loss_cls_weight = loss_cls_weight
        self.loss_bbox_weight = loss_bbox_weight
        self.loss_refine_weight = loss_refine_weight
        self.stacked_convs = stacked_convs
        names = ([f'cls{i}' for i in range(stacked_convs)] +
                 [f'reg{i}' for i in range(stacked_convs)] +
                 ['vfnet_reg_conv'])
        for name in names:
            cin = in_channels if name in ('cls0', 'reg0') else feat_channels
            self.add_module(f'{name}_conv',
                            head_conv(cin, feat_channels, bias=False))
            self.add_module(f'{name}_gn', GroupNorm(GN_GROUPS, feat_channels,
                                                    eps=GN_EPS))
        self.vfnet_reg = head_conv(feat_channels, 4)
        self.refine_dcn = DeformConv2d(feat_channels, feat_channels, 3)
        self.vfnet_reg_refine = head_conv(feat_channels, 4)
        self.cls_dcn = DeformConv2d(feat_channels, feat_channels, 3)
        self.vfnet_cls = head_conv(feat_channels, num_classes,
                                   bias_init=PRIOR_BIAS)
        self.scales = nn.Parameter(torch.ones(len(self.strides)))
        self.scales_refine = nn.Parameter(torch.ones(len(self.strides)))
        self._grids: Dict = {}

    def _gn_conv(self, name, x):
        """conv -> GroupNorm -> ReLU of the block tpudet names ``name``."""
        return F.relu(getattr(self, f'{name}_gn')(
            getattr(self, f'{name}_conv')(x)))

    def star_offsets(self, bbox_pred, stride: int):
        """(B, 4, H, W) ltrb distances (px) -> the DCN offsets (B, 18, H,
        W), (y, x) per tap, the taps row-major over the star
        (``vfnet_head.py:111-124``)."""
        g = self.gradient_mul
        gm = ((1 - g) * bbox_pred.detach() + g * bbox_pred) / stride
        left, top, right, bottom = gm.unbind(dim=1)
        z = torch.zeros_like(left)
        star = (-top, -left, -top, z, -top, right, z, -left, z, z, z, right,
                bottom, -left, bottom, z, bottom, right)
        return torch.stack([v - base for v, base in zip(star, STAR_BASE)],
                           dim=1)

    def forward(self, feats):
        """NCHW features -> (class logits, initial distances, refined
        distances), per-level (B, H, W, attrib) tuples, the distances in
        px and fp32."""
        cls_out, reg_out, refine_out = [], [], []
        for lvl, x in enumerate(feats):
            c = r = x
            for i in range(self.stacked_convs):
                c = self._gn_conv(f'cls{i}', c)
                r = self._gn_conv(f'reg{i}', r)
            ri = self._gn_conv('vfnet_reg_conv', r)
            bbox_pred = torch.exp(scaled(self.vfnet_reg(ri),
                                         self.scales[lvl])) * \
                self.reg_denoms[lvl]
            offsets = self.star_offsets(bbox_pred, self.strides[lvl])
            rr = F.relu(self.refine_dcn(r, offsets)).to(r.dtype)
            refine = torch.exp(scaled(self.vfnet_reg_refine(rr),
                                      self.scales_refine[lvl])) * \
                bbox_pred.detach()
            cc = F.relu(self.cls_dcn(c, offsets)).to(c.dtype)
            cls_out.append(self.vfnet_cls(cc).permute(0, 2, 3, 1))
            reg_out.append(bbox_pred.permute(0, 2, 3, 1))
            refine_out.append(refine.permute(0, 2, 3, 1))
        return tuple(cls_out), tuple(reg_out), tuple(refine_out)

    def _points(self, cls_scores):
        """Per-level points (N_l, 2) at ``(x, y) * stride``, all levels'
        points and anchors, and the counts, on the maps' device (cached)."""
        sizes = tuple(tuple(c.shape[1:3]) for c in cls_scores)
        dev = cls_scores[0].device
        key = (sizes, dev)
        if key not in self._grids:
            pts, anchors = [], []
            for (h, w), s in zip(sizes, self.strides):
                xs = np.tile(np.arange(w, dtype=np.float32), h) * s
                ys = np.repeat(np.arange(h, dtype=np.float32), w) * s
                pts.append(np.stack([xs, ys], -1))
                half = self.anchor_scale * s / 2
                anchors.append(np.stack([xs - half, ys - half, xs + half,
                                         ys + half], -1))
            self._grids[key] = (
                [torch.from_numpy(p).to(dev) for p in pts],
                torch.from_numpy(np.concatenate(pts)).to(dev),
                torch.from_numpy(np.concatenate(anchors)).to(dev),
                [len(p) for p in pts])
        return self._grids[key]

    def loss(self, preds, gt_bboxes, gt_labels, gt_valid
             ) -> Dict[str, torch.Tensor]:
        """``loss_cls`` (varifocal), ``loss_bbox`` (initial GIoU),
        ``loss_bbox_rf`` (refined GIoU) and ``num_gts``
        (``vfnet_head.py:152-212``)."""
        cls_scores, bbox_preds, bbox_refine = preds
        _, points, anchors, counts = self._points(cls_scores)
        b, nc = cls_scores[0].shape[0], self.num_classes
        cls_flat = flat([c.float() for c in cls_scores], b, nc)
        init_boxes = distance_boxes(points[None], flat(bbox_preds, b, 4))
        refine_boxes = distance_boxes(points[None], flat(bbox_refine, b, 4))
        gt_bboxes = gt_bboxes.float()

        assigned = atss_assign_batch(anchors, counts, gt_bboxes, gt_valid,
                                     self.atss_topk)
        pos = assigned >= 0
        num_pos = torch.clamp_min(global_sum(pos.float().sum()), 1.0)
        gt_idx = assigned.clamp_min(0)
        tgt = torch.where(pos[..., None], matched_boxes(gt_bboxes, gt_idx),
                          init_boxes).detach()
        w_ini = torch.clamp_min(bbox_overlaps_aligned(init_boxes, tgt),
                                1e-6).detach() * pos
        w_rf = torch.clamp_min(bbox_overlaps_aligned(refine_boxes, tgt),
                               1e-6).detach() * pos
        loss_bbox = L.giou_loss(
            init_boxes, tgt, weight=w_ini,
            avg_factor=torch.clamp_min(global_sum(w_ini.sum()), 1.0),
            loss_weight=self.loss_bbox_weight)
        loss_refine = L.giou_loss(
            refine_boxes, tgt, weight=w_rf,
            avg_factor=torch.clamp_min(global_sum(w_rf.sum()), 1.0),
            loss_weight=self.loss_refine_weight)
        labels = torch.gather(gt_labels.long(), 1, gt_idx)
        cls_tgt = L.one_hot(labels, nc, torch.float32) * w_rf[..., None]
        loss_cls = L.varifocal_loss(
            cls_flat, cls_tgt, alpha=self.vfl_alpha, gamma=self.vfl_gamma,
            avg_factor=num_pos, loss_weight=self.loss_cls_weight)
        return dict(loss_cls=loss_cls, loss_bbox=loss_bbox,
                    loss_bbox_rf=loss_refine, num_gts=num_gts(gt_valid))

    def get_bboxes(self, preds, scale_factors=None, score_thr: float = 0.05,
                   iou_thr: float = 0.6, max_per_img: int = 100,
                   nms_pre: int = 1000, img_shape=None, with_nms: bool = True,
                   **kwargs):
        """Decode and NMS of the refined distances (``vfnet_head.py:
        215-272``), batched, in fp32. ``img_shape`` is ``(h, w)``: numbers
        or per-image (B, 1) columns. Returns NMSResult, or with
        ``with_nms=False`` ``(boxes, scores)`` without a background column.
        Other keywords are ignored, as tpudet ignores them."""
        cls_scores, _, bbox_refine = preds
        levels, _, _, _ = self._points(cls_scores)
        b, nc = cls_scores[0].shape[0], self.num_classes
        all_boxes, all_scores = [], []
        for lvl, points in enumerate(levels):
            scores = torch.sigmoid(cls_scores[lvl].reshape(b, -1, nc).float())
            ltrb = bbox_refine[lvl].reshape(b, -1, 4)
            n = scores.shape[1]
            k = min(nms_pre, n) if with_nms else 0
            if 0 < k < n:
                scores, ltrb, lvl_points = topk_levels(scores, k, ltrb,
                                                       points)
            else:
                lvl_points = points[None].expand(b, -1, -1)
            boxes = distance_boxes(lvl_points, ltrb)
            if img_shape is not None:  # distance2bbox's max_shape clip
                boxes = torch.stack([
                    _clip_to(boxes[..., 0], img_shape[1]),
                    _clip_to(boxes[..., 1], img_shape[0]),
                    _clip_to(boxes[..., 2], img_shape[1]),
                    _clip_to(boxes[..., 3], img_shape[0])], dim=-1)
            all_boxes.append(boxes)
            all_scores.append(scores)
        return finish_bboxes(all_boxes, all_scores, scale_factors, score_thr,
                             iou_thr, max_per_img, with_nms)
