"""YOLOF's head: port of ``tpudet/models/dense_heads/yolof_head.py``.

One level (the ``DilatedEncoder``'s output, stride 32) with
``len(anchor_scales)`` square anchors a cell: ``num_cls_convs`` and
``num_reg_convs`` biased 3x3 ``ConvModule``s with BN (tpudet's
ConvModule defaults: flax's momentum 0.9, eps 1e-5) and ReLU
(``cls_subnet{i}``, ``bbox_subnet{i}``), then ``cls_score`` (A*C, the
0.01 prior bias), ``bbox_pred`` (A*4) and ``object_pred`` (A) on the
regression subnet, N(0, 0.01^2). The class
logits leave merged with the implicit objectness in fp32:
``cls + obj - log(1 + min(e^cls, 1e8) + min(e^obj, 1e8))``.

``loss``: the uniform matching (``core/assigners.uniform_assign_batch``)
on the decoded predictions (``DeltaXYWHBBoxCoder`` with ``add_ctr_clamp``,
32 px) and the anchors; the sigmoid focal loss over positives and
negatives by ``max(num_pos, 1)``; GIoU over every candidate pair
(duplicates included, each against its own gt) by the same count, every
rank's batch counted. ``get_bboxes``: the top ``nms_pre`` by the best
class score (ties by index), the clamped decode clipped to
``img_shape``, then ``batched_nms``.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
from torch import nn

from ...core.anchors import AnchorGenerator
from ...core.assigners import (NEGATIVE, uniform_assign_batch,
                               uniform_match_pairs_batch)
from ...core.bbox import DeltaXYWHBBoxCoder
from ...core.nms import batched_nms
from ...parallel.mesh import global_sum
from ...registry import HEADS
from .. import losses as L
from ..layers import ConvModule
from .atss_head import PRIOR_BIAS, head_conv, matched_boxes, no_dtype, \
    num_gts, topk_levels

INF = 1e8


@HEADS.register_module()
class YOLOFHead(nn.Module):
    """The keyword arguments are tpudet's fields (``yolof_head.py:31-46``)
    with its defaults."""

    def __init__(self, num_classes: int, in_channels: int = 512,
                 num_cls_convs: int = 2, num_reg_convs: int = 4,
                 stride: int = 32,
                 anchor_scales: Sequence[int] = (1, 2, 4, 8, 16),
                 match_times: int = 4, pos_ignore_thr: float = 0.15,
                 neg_ignore_thr: float = 0.7, focal_gamma: float = 2.0,
                 focal_alpha: float = 0.25, loss_cls_weight: float = 1.0,
                 loss_bbox_weight: float = 1.0, dtype=None):
        super().__init__()
        no_dtype('YOLOFHead', dtype)
        self.num_classes = num_classes
        self.num_anchors = len(anchor_scales)
        self.match_times = match_times
        self.pos_ignore_thr = pos_ignore_thr
        self.neg_ignore_thr = neg_ignore_thr
        self.focal_gamma = focal_gamma
        self.focal_alpha = focal_alpha
        self.loss_cls_weight = loss_cls_weight
        self.loss_bbox_weight = loss_bbox_weight
        self.anchor_generator = AnchorGenerator(
            strides=[stride], ratios=[1.0], scales=list(anchor_scales))
        self.bbox_coder = DeltaXYWHBBoxCoder(add_ctr_clamp=True,
                                             ctr_clamp=32)
        self.num_cls_convs, self.num_reg_convs = num_cls_convs, num_reg_convs
        for name, n in (('cls_subnet', num_cls_convs),
                        ('bbox_subnet', num_reg_convs)):
            for i in range(n):
                self.add_module(f'{name}{i}', ConvModule(
                    in_channels, in_channels, 3, act='ReLU', bias=True,
                    bn_eps=1e-5, bn_momentum=0.1))
        a = self.num_anchors
        self.cls_score = head_conv(in_channels, a * num_classes,
                                   bias_init=PRIOR_BIAS)
        self.bbox_pred = head_conv(in_channels, a * 4)
        self.object_pred = head_conv(in_channels, a)
        self._grids: Dict = {}

    def forward(self, feats):
        """The last NCHW level -> ((merged class logits (B, H, W, A*C),
        fp32), (deltas (B, H, W, A*4),))."""
        x = feats[-1] if isinstance(feats, (tuple, list)) else feats
        c = r = x
        for i in range(self.num_cls_convs):
            c = getattr(self, f'cls_subnet{i}')(c)
        for i in range(self.num_reg_convs):
            r = getattr(self, f'bbox_subnet{i}')(r)
        b, _, h, w = x.shape
        a, nc = self.num_anchors, self.num_classes
        cls = self.cls_score(c).permute(0, 2, 3, 1).float().reshape(
            b, h, w, a, nc)
        obj = self.object_pred(r).permute(0, 2, 3, 1).float().reshape(
            b, h, w, a, 1)
        norm = cls + obj - torch.log(1. + torch.clamp_max(torch.exp(cls), INF)
                                     + torch.clamp_max(torch.exp(obj), INF))
        return ((norm.reshape(b, h, w, a * nc),),
                (self.bbox_pred(r).permute(0, 2, 3, 1),))

    def _anchors(self, cls_score):
        key = (tuple(cls_score.shape[1:3]), cls_score.device)
        if key not in self._grids:
            self._grids[key] = torch.from_numpy(np.concatenate(
                self.anchor_generator.grid_anchors([key[0]]))).to(key[1])
        return self._grids[key]

    def loss(self, preds, gt_bboxes, gt_labels, gt_valid
             ) -> Dict[str, torch.Tensor]:
        """``loss_cls``, ``loss_bbox``, ``num_gts`` (``yolof_head.py:
        112-150``), in fp32 or wider. gt_bboxes (B, G, 4) zero-padded xyxy,
        gt_labels (B, G), gt_valid (B, G)."""
        (cls_score,), (bbox_pred,) = preds
        b, nc = cls_score.shape[0], self.num_classes
        cls_flat = cls_score.reshape(b, -1, nc).float()
        reg_flat = bbox_pred.reshape(b, -1, 4).float()
        gts = gt_bboxes.to(reg_flat.dtype)
        anchors = self._anchors(cls_score).to(gts.dtype)
        pred_boxes = self.bbox_coder.decode(anchors[None], reg_flat)
        with torch.no_grad():
            assigned = uniform_assign_batch(
                pred_boxes, anchors, gts, gt_valid, self.match_times,
                self.pos_ignore_thr, self.neg_ignore_thr)
            pair_a, pair_g, pair_pos = uniform_match_pairs_batch(
                pred_boxes, anchors, gts, gt_valid, self.match_times,
                self.pos_ignore_thr)
        pos = assigned >= 0
        neg = assigned == NEGATIVE
        num_pos = torch.clamp_min(global_sum(pos.to(gts.dtype).sum()), 1.0)
        labels = torch.gather(gt_labels.long(), 1, assigned.clamp_min(0))
        onehot = L.one_hot(labels, nc, cls_flat.dtype) * pos[..., None]
        loss_cls = L.sigmoid_focal_loss(
            cls_flat, onehot, gamma=self.focal_gamma, alpha=self.focal_alpha,
            weight=(pos | neg).to(gts.dtype)[..., None], avg_factor=num_pos,
            loss_weight=self.loss_cls_weight)
        pair_pred = matched_boxes(pred_boxes, pair_a)
        pair_tgt = torch.where(pair_pos[..., None],
                               matched_boxes(gts, pair_g), pair_pred)
        loss_bbox = L.giou_loss(pair_pred, pair_tgt,
                                weight=pair_pos.to(gts.dtype),
                                avg_factor=num_pos,
                                loss_weight=self.loss_bbox_weight)
        return dict(loss_cls=loss_cls, loss_bbox=loss_bbox,
                    num_gts=num_gts(gt_valid))

    def get_bboxes(self, preds, scale_factors=None, score_thr: float = 0.05,
                   iou_thr: float = 0.6, max_per_img: int = 100,
                   nms_pre: int = 1000, img_shape=None, with_nms: bool = True,
                   **kwargs):
        """Decode and NMS (``yolof_head.py:153-186``), batched, in fp32.
        ``img_shape`` is ``(h, w)``: numbers or per-image (B, 1) columns.
        Returns NMSResult, or with ``with_nms=False`` ``(boxes (B, N, 4),
        scores (B, N, C))``."""
        (cls_score,), (bbox_pred,) = preds
        b, nc = cls_score.shape[0], self.num_classes
        anchors = self._anchors(cls_score)
        scores = torch.sigmoid(cls_score.reshape(b, -1, nc).float())
        deltas = bbox_pred.reshape(b, -1, 4).float()
        n = scores.shape[1]
        k = min(nms_pre, n) if with_nms else 0
        if 0 < k < n:
            scores, deltas, anchors = topk_levels(scores, k, deltas, anchors)
        else:
            anchors = anchors[None].expand(b, -1, -1)
        boxes = self.bbox_coder.decode(anchors, deltas, max_shape=img_shape)
        if scale_factors is not None:
            scale_factors = torch.as_tensor(scale_factors, dtype=boxes.dtype,
                                            device=boxes.device)
            boxes = boxes / scale_factors[:, None, :]
        if not with_nms:
            return boxes, scores
        return batched_nms(boxes, scores, score_thr, iou_thr, max_per_img,
                           nms_pre=min(4096, boxes.shape[1]))
