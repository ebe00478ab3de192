"""FCOS head: port of ``tpudet/models/dense_heads/fcos_head.py``
(``level_points``, ``FCOSHead``).

Two towers of ``stacked_convs`` plain biased 3x3 convs with ReLU
(``cls_conv{i}``, ``reg_conv{i}``; tpudet's tower has no GroupNorm,
whatever the config's name says), then ``conv_cls`` (C outputs, the 0.01
prior bias), ``conv_reg`` and ``conv_centerness`` on the regression tower;
every conv N(0, 0.01^2). The regression is ``exp(scales[lvl] * x)`` of
the raw map rounded to fp32 (``atss_head.scaled``), so distances leave the
head positive and in fp32. Pred maps leave it in tpudet's layout, (B, H,
W, attrib).

``loss``: each point (at ``(i + 0.5) * stride``) takes, among the gts that
contain it strictly and whose largest side distance lies in the level's
regress range, the one of least area (the first on a tie); the sigmoid
focal loss over ``max(num_pos, 1)``; ``-log(IoU)`` of the decoded boxes
weighted by the centerness target over its sum; BCE of the centerness at
the positives over ``max(num_pos, 1)``. Every denominator counts every
rank's batch. ``get_bboxes``: the class probabilities times the
centerness probability, the top ``nms_pre`` of each level (ties by
index), the distances decoded and clipped to ``img_shape``, then
``batched_nms`` of the top 2048 (box, class) pairs.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...core.bbox import _clip_to
from ...parallel.mesh import global_sum
from ...registry import HEADS
from .. import losses as L
from .atss_head import (PRIOR_BIAS, finish_bboxes, flat, head_conv, no_dtype,
                        num_gts, scaled, topk_levels)

INF = 1e8


def level_points(featmap_size, stride) -> np.ndarray:
    """(H*W, 2) fp32 point centres at ``(i + 0.5) * stride``, x fastest."""
    h, w = featmap_size
    xs = (np.arange(w, dtype=np.float32) + 0.5) * stride
    ys = (np.arange(h, dtype=np.float32) + 0.5) * stride
    return np.stack([np.tile(xs, h), np.repeat(ys, w)], axis=-1)


class PointCache:
    """Per-level points of ``points_fn(size, stride)`` for the pred maps'
    sizes, their concatenation and per-point extras (``extras(level,
    n)`` -> (n, k) rows, concatenated), on the maps' device, cached per
    sizes and device."""

    def __init__(self, strides, points_fn=level_points, extras=None):
        self.strides = tuple(strides)
        self.points_fn = points_fn
        self.extras = extras
        self._cache: Dict = {}

    def __call__(self, maps):
        sizes = tuple(tuple(m.shape[1:3]) for m in maps)
        dev = maps[0].device
        key = (sizes, dev)
        if key not in self._cache:
            levels = [self.points_fn(s, st)
                      for s, st in zip(sizes, self.strides)]
            extra = None if self.extras is None else torch.from_numpy(
                np.concatenate([self.extras(i, len(p))
                                for i, p in enumerate(levels)])).to(dev)
            self._cache[key] = (
                [torch.from_numpy(p).to(dev) for p in levels],
                torch.from_numpy(np.concatenate(levels)).to(dev), extra)
        return self._cache[key]


def distance_boxes(points, ltrb):
    """Boxes at ``points`` (..., 2) from (..., 4) left, top, right, bottom
    distances."""
    return torch.stack([points[..., 0] - ltrb[..., 0],
                        points[..., 1] - ltrb[..., 1],
                        points[..., 0] + ltrb[..., 2],
                        points[..., 1] + ltrb[..., 3]], dim=-1)


def clip_boxes(boxes, img_shape, margin: float = 0.):
    """Corners clipped to [0, side - margin] of ``img_shape`` ``(h, w)``
    (numbers or per-image (B, 1) columns)."""
    if img_shape is None:
        return boxes
    h, w = img_shape
    if margin:
        h, w = h - margin, w - margin
    return torch.stack([_clip_to(boxes[..., 0], w), _clip_to(boxes[..., 1], h),
                        _clip_to(boxes[..., 2], w),
                        _clip_to(boxes[..., 3], h)], dim=-1)


def smallest_area_gt(cand, areas):
    """(B, P) index of the least-area candidate gt (the first on a tie) and
    (B, P) whether any: ``cand`` (B, P, G), ``areas`` (B, G)."""
    key = torch.where(cand, areas[:, None, :], areas.new_tensor(INF))
    return key.argmin(dim=2), cand.any(dim=2)


@HEADS.register_module()
class FCOSHead(nn.Module):
    """The keyword arguments are tpudet's fields (``fcos_head.py:38-50``)
    with its defaults. ``scales`` is tpudet's raw ``scales`` leaf (ones);
    ``center_sampling`` and its radius are fields tpudet never reads."""

    flax_leaves = {'scales': ('scales', '')}
    leaf_init = {'scales': 1.0}

    def __init__(self, num_classes: int, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 strides: Sequence[int] = (8, 16, 32, 64, 128),
                 regress_ranges=((-1, 64), (64, 128), (128, 256),
                                 (256, 512), (512, INF)),
                 center_sampling: bool = False,
                 center_sample_radius: float = 1.5,
                 focal_gamma: float = 2.0, focal_alpha: float = 0.25,
                 dtype=None):
        super().__init__()
        no_dtype(type(self).__name__, dtype)
        self.num_classes = num_classes
        self.strides = tuple(strides)
        self.regress_ranges = tuple(tuple(r) for r in regress_ranges)
        self.focal_gamma = focal_gamma
        self.focal_alpha = focal_alpha
        self.stacked_convs = stacked_convs
        self._points = PointCache(
            self.strides, extras=lambda i, n: np.tile(np.asarray(
                self.regress_ranges[i], np.float32), (n, 1)))
        self.build_towers(in_channels, feat_channels)
        self.conv_cls = head_conv(feat_channels, num_classes,
                                  bias_init=PRIOR_BIAS)
        self.conv_reg = head_conv(feat_channels, 4)
        self.conv_centerness = head_conv(feat_channels, 1)
        self.scales = nn.Parameter(torch.ones(len(self.strides)))

    def build_towers(self, in_channels, feat_channels):
        for branch in ('cls', 'reg'):
            cin = in_channels
            for i in range(self.stacked_convs):
                self.add_module(f'{branch}_conv{i}',
                                head_conv(cin, feat_channels))
                cin = feat_channels

    def tower(self, branch: str, x):
        for i in range(self.stacked_convs):
            x = F.relu(getattr(self, f'{branch}_conv{i}')(x))
        return x

    def forward(self, feats):
        """NCHW features -> (class logits, distances (fp32), centerness
        logits), per-level (B, H, W, attrib) tuples."""
        cls_out, reg_out, ctr_out = [], [], []
        for lvl, feat in enumerate(feats):
            c, r = self.tower('cls', feat), self.tower('reg', feat)
            cls_out.append(self.conv_cls(c).permute(0, 2, 3, 1))
            reg_out.append(torch.exp(scaled(self.conv_reg(r),
                                            self.scales[lvl])
                                     ).permute(0, 2, 3, 1))
            ctr_out.append(self.conv_centerness(r).permute(0, 2, 3, 1))
        return tuple(cls_out), tuple(reg_out), tuple(ctr_out)

    def loss(self, preds, gt_bboxes, gt_labels, gt_valid
             ) -> Dict[str, torch.Tensor]:
        """``loss_cls``, ``loss_bbox``, ``loss_centerness``, ``num_gts``
        (``fcos_head.py:110-193``), in fp32 or wider. gt_bboxes (B, G, 4)
        zero-padded xyxy, gt_labels (B, G), gt_valid (B, G)."""
        cls_scores, bbox_preds, centernesses = preds
        _, points, ranges = self._points(cls_scores)
        b, nc = cls_scores[0].shape[0], self.num_classes
        cls_flat = flat([c.float() for c in cls_scores], b, nc)
        reg_flat = flat([r.float() for r in bbox_preds], b, 4)
        ctr_flat = flat([c.float() for c in centernesses], b, 1)[..., 0]
        gts = gt_bboxes.to(reg_flat.dtype)
        points, ranges = points.to(gts.dtype), ranges.to(gts.dtype)

        # (B, P, G, 4) distances of each point to each gt's sides
        ltrb = torch.stack([
            points[None, :, None, 0] - gts[:, None, :, 0],
            points[None, :, None, 1] - gts[:, None, :, 1],
            gts[:, None, :, 2] - points[None, :, None, 0],
            gts[:, None, :, 3] - points[None, :, None, 1]], dim=-1)
        maxd = ltrb.amax(dim=-1)
        cand = ((ltrb.amin(dim=-1) > 0) & (maxd >= ranges[None, :, None, 0])
                & (maxd <= ranges[None, :, None, 1]) & gt_valid[:, None, :])
        areas = (gts[..., 2] - gts[..., 0]) * (gts[..., 3] - gts[..., 1])
        gt_idx, pos = smallest_area_gt(cand, areas)
        tgt = torch.gather(ltrb, 2, gt_idx[..., None, None].expand(
            -1, -1, 1, 4))[:, :, 0]  # (B, P, 4)
        num_pos = torch.clamp_min(global_sum(pos.to(tgt.dtype).sum()), 1.0)

        labels = torch.gather(gt_labels.long(), 1, gt_idx)
        onehot = L.one_hot(labels, nc, cls_flat.dtype) * pos[..., None]
        loss_cls = L.sigmoid_focal_loss(
            cls_flat, onehot, gamma=self.focal_gamma, alpha=self.focal_alpha,
            avg_factor=num_pos)

        lr, tb = tgt[..., [0, 2]], tgt[..., [1, 3]]
        ctr_tgt = torch.sqrt(torch.clamp(
            (lr.amin(-1) / torch.clamp_min(lr.amax(-1), 1e-6)) *
            (tb.amin(-1) / torch.clamp_min(tb.amax(-1), 1e-6)), 0., 1.))
        ctr_tgt = torch.where(pos, ctr_tgt, torch.zeros_like(ctr_tgt))

        pred_boxes = distance_boxes(points[None], reg_flat)
        tgt_boxes = distance_boxes(points[None], torch.clamp_min(tgt, 0.))
        w = ctr_tgt * pos
        # rows of weight 0 still pass through -log(IoU): they take their
        # own prediction as the target, so the log stays finite
        tgt_safe = torch.where((w > 0)[..., None], tgt_boxes,
                               pred_boxes.detach())
        loss_bbox = L.iou_loss(
            pred_boxes, tgt_safe, weight=w,
            avg_factor=torch.clamp_min(global_sum(w.sum()), 1e-6))
        loss_ctr = L.bce_loss(ctr_flat, ctr_tgt, weight=pos.to(tgt.dtype),
                              avg_factor=num_pos)
        return dict(loss_cls=loss_cls, loss_bbox=loss_bbox,
                    loss_centerness=loss_ctr, num_gts=num_gts(gt_valid))

    def get_bboxes(self, preds, scale_factors=None, score_thr: float = 0.05,
                   iou_thr: float = 0.5, max_per_img: int = 100,
                   nms_pre: int = 1000, img_shape=None, with_nms: bool = True,
                   **kwargs):
        """Decode and NMS (``fcos_head.py:196-243``), batched, in fp32.
        ``img_shape`` is ``(h, w)``: numbers or per-image (B, 1) columns.
        Returns NMSResult, or with ``with_nms=False`` ``(boxes (B, N, 4),
        scores (B, N, C))``. Other keywords are ignored, as tpudet ignores
        them."""
        cls_scores, bbox_preds, centernesses = preds
        levels, _, _ = self._points(cls_scores)
        b, nc = cls_scores[0].shape[0], self.num_classes
        all_boxes, all_scores = [], []
        for lvl, pts in enumerate(levels):
            scores = torch.sigmoid(cls_scores[lvl].reshape(b, -1, nc).float())
            ctr = torch.sigmoid(centernesses[lvl].reshape(b, -1).float())
            scores = scores * ctr[..., None]
            ltrb = bbox_preds[lvl].reshape(b, -1, 4).float()
            n = scores.shape[1]
            k = min(nms_pre, n) if with_nms else 0
            if 0 < k < n:
                scores, ltrb, pts = topk_levels(scores, k, ltrb, pts)
            else:
                pts = pts[None].expand(b, -1, -1)
            all_boxes.append(clip_boxes(distance_boxes(pts, ltrb),
                                        img_shape))
            all_scores.append(scores)
        return finish_bboxes(all_boxes, all_scores, scale_factors, score_thr,
                             iou_thr, max_per_img, with_nms)
