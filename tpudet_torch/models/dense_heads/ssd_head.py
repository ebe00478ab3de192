"""SSD head and the ``SSD`` detector: port of
``tpudet/models/dense_heads/ssd_head.py``.

One 3x3 conv a level for the classes and one for the deltas
(``cls_conv{i}`` with A*(C+1) outputs, the background column last;
``reg_conv{i}`` with A*4), ``xavier_uniform`` with zero biases, A the
level's anchors of ``SSDAnchorGenerator`` (``scale_major=False``). Pred
maps leave the head in tpudet's layout, (B, H, W, A*attrib).

``loss``: the dense MaxIoU assigner at 0.5 / 0.5 with low-quality
matches; softmax cross-entropy with hard-negative mining: each image
keeps exactly ``3 * pos_i`` negatives, those of the highest loss, ranked
by a stable sort (ties by anchor index, as ``jnp.argsort``), and an image
without positives keeps none (no zero-positive fallback); smooth-L1 of
the deltas (``target_stds`` 0.1, 0.1, 0.2, 0.2) over the positives; both
over ``sum_i max(pos_i, 1)``, summed over every rank's batch.

``get_bboxes``: the softmax, the deltas decoded (clipped to ``img_shape``,
divided by ``scale_factors``), then class-aware NMS of the top
``min(2048, A)`` (box, class) pairs without the background column;
``with_nms=False`` returns the boxes and the softmax with it.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ...core.anchors import SSDAnchorGenerator
from ...core.assigners import NEGATIVE, max_iou_assign_batch
from ...core.bbox import DeltaXYWHBBoxCoder
from ...core.nms import batched_nms
from ...parallel.mesh import global_count, global_sum
from ...registry import DETECTORS, HEADS
from .. import losses as L
from ..backbones.ssd_vgg import conv_or_empty
from ..detectors.single_stage import SingleStageDetector
from ..layers import Conv


@HEADS.register_module()
class SSDHead(nn.Module):
    """The keyword arguments are tpudet's fields (``ssd_head.py:27-45``)
    with its defaults."""

    def __init__(self, num_classes: int = 80,
                 in_channels: Sequence[int] = (512, 1024, 512, 256, 256,
                                               256),
                 strides: Sequence[int] = (8, 16, 32, 64, 100, 300),
                 ratios: Sequence = ((2,), (2, 3), (2, 3), (2, 3), (2,),
                                     (2,)),
                 basesize_ratio_range: Tuple[float, float] = (0.15, 0.9),
                 input_size: int = 300, scale_major: bool = False,
                 target_stds: Sequence[float] = (0.1, 0.1, 0.2, 0.2),
                 pos_iou_thr: float = 0.5, neg_iou_thr: float = 0.5,
                 neg_pos_ratio: int = 3, smoothl1_beta: float = 1.0,
                 dtype=None):
        super().__init__()
        if dtype is not None:
            raise ValueError(f'SSDHead: dtype={dtype!r} is not a module '
                             f'setting in the port; see '
                             f'SingleStageDetector.set_dtype')
        self.num_classes = num_classes
        self.cls_out_channels = num_classes + 1
        self.pos_iou_thr, self.neg_iou_thr = pos_iou_thr, neg_iou_thr
        self.neg_pos_ratio = neg_pos_ratio
        self.smoothl1_beta = smoothl1_beta
        self.anchor_generator = SSDAnchorGenerator(
            strides=list(strides), ratios=[list(r) for r in ratios],
            basesize_ratio_range=tuple(basesize_ratio_range),
            input_size=input_size, scale_major=scale_major)
        self.bbox_coder = DeltaXYWHBBoxCoder(target_stds=target_stds)
        self.num_levels = len(in_channels)
        for i, (cin, a) in enumerate(zip(
                in_channels, self.anchor_generator.num_base_anchors)):
            self.add_module(f'cls_conv{i}', Conv(
                cin, a * self.cls_out_channels, 3, 1, 1,
                kernel_init='xavier_uniform'))
            self.add_module(f'reg_conv{i}', Conv(
                cin, a * 4, 3, 1, 1, kernel_init='xavier_uniform'))
        self._grids: Dict = {}

    def forward(self, feats):
        """NCHW features -> (per-level (B, H, W, A*(C+1)) class logits,
        per-level (B, H, W, A*4) deltas)."""
        cls_out, reg_out = [], []
        for i, feat in enumerate(feats):
            cls_out.append(conv_or_empty(getattr(self, f'cls_conv{i}'),
                                         feat).permute(0, 2, 3, 1))
            reg_out.append(conv_or_empty(getattr(self, f'reg_conv{i}'),
                                         feat).permute(0, 2, 3, 1))
        return tuple(cls_out), tuple(reg_out)

    def _anchors(self, cls_scores):
        """All levels' anchors on the pred maps' device (cached per
        featmap sizes and device)."""
        sizes = tuple(tuple(c.shape[1:3]) for c in cls_scores)
        key = (sizes, cls_scores[0].device)
        if key not in self._grids:
            self._grids[key] = torch.from_numpy(np.concatenate(
                self.anchor_generator.grid_anchors(sizes))).to(key[1])
        return self._grids[key]

    def _flat(self, preds):
        cls_scores, bbox_preds = preds
        b = cls_scores[0].shape[0]
        cls_flat = torch.cat([c.reshape(b, -1, self.cls_out_channels).float()
                              for c in cls_scores], dim=1)
        reg_flat = torch.cat([r.reshape(b, -1, 4).float()
                              for r in bbox_preds], dim=1)
        return self._anchors(cls_scores), cls_flat, reg_flat

    def loss(self, preds, gt_bboxes, gt_labels, gt_valid
             ) -> Dict[str, torch.Tensor]:
        """Cross-entropy with hard-negative mining and smooth-L1, in fp32
        or wider (``ssd_head.py:89-138``).

        Args:
            preds: ``(cls_scores, bbox_preds)`` per-level tuples.
            gt_bboxes: (B, G, 4) zero-padded, xyxy; gt_labels: (B, G)
                0-based; gt_valid: (B, G) bool.

        Returns:
            dict with ``loss_cls``, ``loss_bbox`` and ``num_gts``.
        """
        anchors, cls_flat, reg_flat = self._flat(preds)
        gt_bboxes = gt_bboxes.to(reg_flat.dtype)
        assigned = max_iou_assign_batch(anchors, gt_bboxes, gt_valid,
                                        self.pos_iou_thr, self.neg_iou_thr,
                                        0.0, True)
        pos = assigned >= 0
        neg = assigned == NEGATIVE
        pos_per_img = pos.sum(1)
        num_pos = global_sum(torch.clamp_min(pos_per_img.to(
            cls_flat.dtype), 1.0).sum())
        gt_idx = assigned.clamp_min(0)
        labels = torch.where(pos, torch.gather(gt_labels.long(), 1, gt_idx),
                             self.num_classes)
        ce = -torch.gather(torch.log_softmax(cls_flat, dim=-1), 2,
                           labels[..., None])[..., 0]
        # hard negatives: each image's 3 * pos_i negatives of the highest
        # loss, by rank (a stable sort: ties by anchor index)
        neg_ce = torch.where(neg, ce, torch.full_like(ce, -1.0))
        order = torch.argsort(-neg_ce, dim=1, stable=True)
        rank = torch.empty_like(order).scatter_(
            1, order, torch.arange(order.shape[1], device=order.device
                                   ).expand_as(order))
        neg_keep = neg & (rank < self.neg_pos_ratio * pos_per_img[:, None])
        loss_cls = (ce * (pos | neg_keep)).sum() / num_pos

        matched = torch.gather(gt_bboxes, 1,
                               gt_idx[..., None].expand(-1, -1, 4))
        matched = torch.where(pos[..., None], matched, anchors[None])
        deltas = self.bbox_coder.encode(anchors[None], matched)
        loss_bbox = L.smooth_l1_loss(
            reg_flat, deltas, beta=self.smoothl1_beta,
            weight=pos[..., None].to(reg_flat.dtype), avg_factor=num_pos)
        num_gts = gt_valid.float().sum() / global_count(gt_valid.shape[0],
                                                        gt_valid.device)
        return dict(loss_cls=loss_cls, loss_bbox=loss_bbox, num_gts=num_gts)

    def get_bboxes(self, preds, scale_factors=None, score_thr: float = 0.02,
                   iou_thr: float = 0.45, max_per_img: int = 200,
                   nms_pre: int = 1000, img_shape=None, with_nms: bool = True,
                   **kwargs):
        """Softmax, decode, class-aware NMS (``ssd_head.py:141-164``).
        ``nms_pre`` is taken and not used, as tpudet's: NMS takes the top
        ``min(2048, A)`` pairs."""
        anchors, cls_flat, reg_flat = self._flat(preds)
        softmax_scores = torch.softmax(cls_flat, dim=-1)
        boxes = self.bbox_coder.decode(anchors[None], reg_flat,
                                       max_shape=img_shape)
        if scale_factors is not None:
            scale_factors = torch.as_tensor(scale_factors, dtype=boxes.dtype,
                                            device=boxes.device)
            boxes = boxes / scale_factors[:, None, :]
        if not with_nms:
            return boxes, softmax_scores
        scores = softmax_scores[..., :-1]
        return batched_nms(boxes, scores, score_thr, iou_thr, max_per_img,
                           nms_pre=min(2048, scores.shape[1]))


@DETECTORS.register_module()
class SSD(SingleStageDetector):
    """SSD (``ssd_head.py:167-178``): no neck; ``test_cfg``'s ``nms``
    gives only ``iou_thr`` (0.45 by default) and ``min_bbox_size`` is
    dropped."""

    def get_bboxes(self, pred_maps, **kwargs):
        cfg = dict(self.test_cfg or {})
        nms_cfg = cfg.pop('nms', None)
        if nms_cfg is not None:
            cfg['iou_thr'] = nms_cfg.get('iou_threshold', 0.45)
        cfg.pop('min_bbox_size', None)
        cfg.update(kwargs)
        return self.bbox_head.get_bboxes(pred_maps, **cfg)
