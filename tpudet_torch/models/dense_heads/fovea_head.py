"""FoveaBox head: port of ``tpudet/models/dense_heads/fovea_head.py``.

Towers of ``stacked_convs`` biased 3x3 convs with ReLU (``cls_conv{i}``,
``reg_conv{i}``), ``conv_cls`` (C outputs, the 0.01 prior bias) and
``conv_reg`` (4 log-distances in units of the level's ``base_edge``);
every conv N(0, 0.01^2).

``loss`` (``fovea_head.py:88-170``): per image and level, each valid gt
whose sqrt-area lies in the level's ``scale_ranges`` covers the cells of
its centre region shrunk by ``sigma`` (the cell indices ``ceil`` /
``floor`` of the shrunk sides on the level's grid, clipped to it); a cell
covered by several takes the one of least sqrt-area (the first on a tie).
Its targets are ``log`` of the distances from ``(i + 0.5) * stride`` to
the gt's sides over ``base_edge``, clipped to [1/16, 16]. The sigmoid
focal loss over ``num_pos + B`` and smooth L1 (``smooth_l1_beta``) of the
positives over ``max(num_pos, 1)``, both counting every rank's batch.

``get_bboxes``: the class probabilities, the top ``nms_pre`` of each level
(ties by index), ``base_edge * exp(reg)`` around the points, corners
clipped to ``img_shape - 1``, then ``batched_nms`` of the top 2048 pairs.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...parallel.mesh import global_count, global_sum
from ...registry import HEADS
from .. import losses as L
from .atss_head import (PRIOR_BIAS, finish_bboxes, flat, head_conv, no_dtype,
                        num_gts, topk_levels)
from .fcos_head import INF, PointCache, clip_boxes


@HEADS.register_module()
class FoveaHead(nn.Module):
    """The keyword arguments are tpudet's fields (``fovea_head.py:33-47``)
    with its defaults."""

    def __init__(self, num_classes: int, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 strides: Sequence[int] = (8, 16, 32, 64, 128),
                 base_edge_list: Sequence[int] = (16, 32, 64, 128, 256),
                 scale_ranges=((8, 32), (16, 64), (32, 128), (64, 256),
                               (128, 512)),
                 sigma: float = 0.4, focal_gamma: float = 2.0,
                 focal_alpha: float = 0.25, smooth_l1_beta: float = 0.11,
                 loss_bbox_weight: float = 1.0, dtype=None):
        super().__init__()
        no_dtype('FoveaHead', dtype)
        self.num_classes = num_classes
        self.strides = tuple(strides)
        self.base_edge_list = tuple(base_edge_list)
        self.scale_ranges = tuple(tuple(r) for r in scale_ranges)
        self.sigma = sigma
        self.focal_gamma = focal_gamma
        self.focal_alpha = focal_alpha
        self.smooth_l1_beta = smooth_l1_beta
        self.loss_bbox_weight = loss_bbox_weight
        self.stacked_convs = stacked_convs
        self._points = PointCache(self.strides)
        for branch in ('cls', 'reg'):
            cin = in_channels
            for i in range(stacked_convs):
                self.add_module(f'{branch}_conv{i}',
                                head_conv(cin, feat_channels))
                cin = feat_channels
        self.conv_cls = head_conv(feat_channels, num_classes,
                                  bias_init=PRIOR_BIAS)
        self.conv_reg = head_conv(feat_channels, 4)

    def forward(self, feats):
        """NCHW features -> (class logits, log-distances), per-level (B,
        H, W, attrib) tuples."""
        cls_out, reg_out = [], []
        for feat in feats:
            c = r = feat
            for i in range(self.stacked_convs):
                c = F.relu(getattr(self, f'cls_conv{i}')(c))
                r = F.relu(getattr(self, f'reg_conv{i}')(r))
            cls_out.append(self.conv_cls(c).permute(0, 2, 3, 1))
            reg_out.append(self.conv_reg(r).permute(0, 2, 3, 1))
        return tuple(cls_out), tuple(reg_out)

    def _level_targets(self, lvl, size, pts, gts, labels, valid):
        """One level of the batch: (B, H*W) labels (``num_classes`` for the
        background), (B, H*W, 4) log targets, (B, H*W) positives."""
        s, base = self.strides[lvl], self.base_edge_list[lvl]
        lo, hi = self.scale_ranges[lvl]
        h, w = size
        area = torch.sqrt(torch.clamp_min(
            (gts[..., 2] - gts[..., 0]) * (gts[..., 3] - gts[..., 1]), 0.))
        hit = (area >= lo) & (area <= hi) & valid  # (B, G)
        gs = gts / s
        half_w = 0.5 * (gs[..., 2] - gs[..., 0])
        half_h = 0.5 * (gs[..., 3] - gs[..., 1])
        left = torch.clamp(torch.ceil(gs[..., 0] + (1 - self.sigma) * half_w
                                      - 0.5), 0, w - 1)
        right = torch.clamp(torch.floor(gs[..., 0] + (1 + self.sigma) *
                                        half_w - 0.5), 0, w - 1)
        top = torch.clamp(torch.ceil(gs[..., 1] + (1 - self.sigma) * half_h
                                     - 0.5), 0, h - 1)
        down = torch.clamp(torch.floor(gs[..., 1] + (1 + self.sigma) *
                                       half_h - 0.5), 0, h - 1)
        cx = torch.arange(w, dtype=gts.dtype, device=gts.device)
        cy = torch.arange(h, dtype=gts.dtype, device=gts.device)
        in_x = (cx >= left[..., None]) & (cx <= right[..., None])  # (B, G, W)
        in_y = (cy >= top[..., None]) & (cy <= down[..., None])  # (B, G, H)
        cover = (in_y[..., :, None] & in_x[..., None, :] &
                 hit[..., None, None]).flatten(2)  # (B, G, P)
        key = torch.where(cover, area[..., None], area.new_tensor(INF))
        winner = key.argmin(dim=1)  # (B, P), the first on a tie
        pos = cover.any(dim=1)
        out_labels = torch.where(pos, torch.gather(labels.long(), 1, winner),
                                 self.num_classes)
        g = torch.gather(gts, 1, winner[..., None].expand(-1, -1, 4))
        px, py = pts[:, 0].to(gts.dtype), pts[:, 1].to(gts.dtype)
        t = torch.stack([(px - g[..., 0]) / base, (py - g[..., 1]) / base,
                         (g[..., 2] - px) / base, (g[..., 3] - py) / base],
                        dim=-1)
        return out_labels, torch.log(torch.clamp(t, 1. / 16, 16.)), pos

    def loss(self, preds, gt_bboxes, gt_labels, gt_valid
             ) -> Dict[str, torch.Tensor]:
        """``loss_cls``, ``loss_bbox`` and ``num_gts`` (``fovea_head.py:
        133-170``), in fp32 or wider. gt_bboxes (B, G, 4) zero-padded xyxy,
        gt_labels (B, G), gt_valid (B, G)."""
        cls_scores, bbox_preds = preds
        levels, _, _ = self._points(cls_scores)
        b, nc = cls_scores[0].shape[0], self.num_classes
        cls_flat = flat([c.float() for c in cls_scores], b, nc)
        reg_flat = flat([r.float() for r in bbox_preds], b, 4)
        gts = gt_bboxes.to(reg_flat.dtype)
        parts = [self._level_targets(lvl, tuple(c.shape[1:3]), pts, gts,
                                     gt_labels, gt_valid)
                 for lvl, (c, pts) in enumerate(zip(cls_scores, levels))]
        labels, tgt, pos = (torch.cat([p[i] for p in parts], dim=1)
                            for i in range(3))
        num_pos = global_sum(pos.to(tgt.dtype).sum())
        onehot = L.one_hot(labels, nc, cls_flat.dtype)  # background: zeros
        loss_cls = L.sigmoid_focal_loss(
            cls_flat, onehot, gamma=self.focal_gamma, alpha=self.focal_alpha,
            avg_factor=num_pos + global_count(b, gts.device))
        loss_bbox = L.smooth_l1_loss(
            reg_flat, tgt, beta=self.smooth_l1_beta,
            weight=pos[..., None].to(tgt.dtype),
            avg_factor=torch.clamp_min(num_pos, 1.0),
            loss_weight=self.loss_bbox_weight)
        return dict(loss_cls=loss_cls, loss_bbox=loss_bbox,
                    num_gts=num_gts(gt_valid))

    def get_bboxes(self, preds, scale_factors=None, score_thr: float = 0.05,
                   iou_thr: float = 0.5, max_per_img: int = 100,
                   nms_pre: int = 1000, img_shape=None, with_nms: bool = True,
                   **kwargs):
        """Decode and NMS (``fovea_head.py:173-224``), batched, in fp32.
        ``img_shape`` is ``(h, w)``: numbers or per-image (B, 1) columns.
        Returns NMSResult, or with ``with_nms=False`` ``(boxes (B, N, 4),
        scores (B, N, C))``."""
        cls_scores, bbox_preds = preds
        levels, _, _ = self._points(cls_scores)
        b, nc = cls_scores[0].shape[0], self.num_classes
        all_boxes, all_scores = [], []
        for lvl, pts in enumerate(levels):
            base = self.base_edge_list[lvl]
            scores = torch.sigmoid(cls_scores[lvl].reshape(b, -1, nc).float())
            reg = torch.exp(bbox_preds[lvl].reshape(b, -1, 4).float())
            n = scores.shape[1]
            k = min(nms_pre, n) if with_nms else 0
            if 0 < k < n:
                scores, reg, pts = topk_levels(scores, k, reg, pts)
            else:
                pts = pts[None].expand(b, -1, -1)
            boxes = torch.stack([pts[..., 0] - base * reg[..., 0],
                                 pts[..., 1] - base * reg[..., 1],
                                 pts[..., 0] + base * reg[..., 2],
                                 pts[..., 1] + base * reg[..., 3]], dim=-1)
            all_boxes.append(clip_boxes(boxes, img_shape, margin=1))
            all_scores.append(scores)
        return finish_bboxes(all_boxes, all_scores, scale_factors, score_thr,
                             iou_thr, max_per_img, with_nms)

