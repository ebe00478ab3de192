"""RetinaNet head and the generic anchor-head loss and decode: port of
``tpudet/models/dense_heads/retina_head.py``.

Two stacks of ``stacked_convs`` 3x3 convs with ReLU (classification and
regression), ``retina_cls`` with A*C outputs and ``retina_reg`` with A*4,
A = ``len(ratios) * scales_per_octave`` anchors per cell on every level.
Every conv draws N(0, 0.01^2) with a zero bias, ``retina_cls`` with the
0.01 prior bias. Pred maps leave the head in tpudet's layout, (B, H, W,
A*attrib) with the anchor axis fastest.

The loss assigns every anchor by the dense MaxIoU assigner over padded
gts (``core/assigners.py``), then sums the sigmoid focal loss over
positives and negatives and the L1 loss of the deltas over positives,
each over ``max(num_pos, 1)``; anchors that match nothing regress to
themselves (delta 0), so ``encode`` never sees a padded gt. Decode takes
the top ``nms_pre`` anchors of each level by their best class score (ties
by index), decodes, clips to ``img_shape`` and runs ``batched_nms``.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...core.anchors import AnchorGenerator
from ...core.assigners import NEGATIVE, max_iou_assign_batch
from ...core.bbox import DeltaXYWHBBoxCoder
from ...core.nms import batched_nms, topk_scores
from ...parallel.mesh import global_count, global_sum
from ...registry import HEADS
from .. import losses as L
from ..layers import Conv


def _conv(cin, cout, bias_init=0.):
    return Conv(cin, cout, 3, 1, 1, kernel_init=('normal', 0.01),
                bias_init=bias_init)


@HEADS.register_module()
class RetinaHead(nn.Module):
    """The keyword arguments are tpudet's fields (``retina_head.py:42-62``)
    with its defaults; ``use_ghm`` trains with the GHM losses."""

    def __init__(self, num_classes: int, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 strides: Sequence[int] = (8, 16, 32, 64, 128),
                 octave_base_scale: int = 4, scales_per_octave: int = 3,
                 ratios: Sequence[float] = (0.5, 1.0, 2.0),
                 target_means: Sequence[float] = (0., 0., 0., 0.),
                 target_stds: Sequence[float] = (1., 1., 1., 1.),
                 pos_iou_thr: float = 0.5, neg_iou_thr: float = 0.4,
                 min_pos_iou: float = 0.0, focal_gamma: float = 2.0,
                 focal_alpha: float = 0.25, loss_cls_weight: float = 1.0,
                 loss_bbox_weight: float = 1.0, use_ghm: bool = False,
                 dtype=None):
        super().__init__()
        if dtype is not None:
            raise ValueError(f'RetinaHead: dtype={dtype!r} is not a module '
                             f'setting in the port; see '
                             f'SingleStageDetector.set_dtype')
        self.num_classes = num_classes
        self.strides = tuple(strides)
        self.pos_iou_thr = pos_iou_thr
        self.neg_iou_thr = neg_iou_thr
        self.min_pos_iou = min_pos_iou
        self.focal_gamma = focal_gamma
        self.focal_alpha = focal_alpha
        self.loss_cls_weight = loss_cls_weight
        self.loss_bbox_weight = loss_bbox_weight
        self.use_ghm = use_ghm
        self.num_anchors = len(ratios) * scales_per_octave
        self.anchor_generator = AnchorGenerator(
            strides=list(self.strides), ratios=list(ratios),
            octave_base_scale=octave_base_scale,
            scales_per_octave=scales_per_octave)
        self.bbox_coder = DeltaXYWHBBoxCoder(target_means, target_stds)
        self.stacked_convs = stacked_convs
        for branch in ('cls', 'reg'):
            cin = in_channels
            for i in range(stacked_convs):
                self.add_module(f'{branch}_conv{i}', _conv(cin,
                                                           feat_channels))
                cin = feat_channels
        # the prior bias puts every class probability at 0.01 at the start
        prior_bias = float(-math.log((1 - 0.01) / 0.01))
        self.retina_cls = _conv(cin, self.num_anchors * num_classes,
                                bias_init=prior_bias)
        self.retina_reg = _conv(cin, self.num_anchors * 4)
        self._grids: Dict = {}

    def forward(self, feats):
        """NCHW features -> (per-level (B, H, W, A*C) class logits,
        per-level (B, H, W, A*4) deltas)."""
        cls_out, reg_out = [], []
        for feat in feats:
            c = r = feat
            for i in range(self.stacked_convs):
                c = F.relu(getattr(self, f'cls_conv{i}')(c))
                r = F.relu(getattr(self, f'reg_conv{i}')(r))
            cls_out.append(self.retina_cls(c).permute(0, 2, 3, 1))
            reg_out.append(self.retina_reg(r).permute(0, 2, 3, 1))
        return tuple(cls_out), tuple(reg_out)

    def _anchors(self, cls_scores):
        """Per-level anchors and all levels' anchors, on the pred maps'
        device (cached per featmap sizes and device)."""
        sizes = tuple(tuple(c.shape[1:3]) for c in cls_scores)
        key = (sizes, cls_scores[0].device)
        if key not in self._grids:
            levels = self.anchor_generator.grid_anchors(sizes)
            dev = cls_scores[0].device
            self._grids[key] = (
                [torch.from_numpy(a).to(dev) for a in levels],
                torch.from_numpy(np.concatenate(levels)).to(dev))
        return self._grids[key]

    def loss(self, preds, gt_bboxes, gt_labels, gt_valid
             ) -> Dict[str, torch.Tensor]:
        """Focal + L1 loss over all anchors, in fp32, or with ``use_ghm``
        GHM-C (30 bins) + GHM-R (mu 0.02, 10 bins, 10x the box weight)
        (``tpudet/models/dense_heads/retina_head.py:113-179``).

        Args:
            preds: ``(cls_scores, bbox_preds)`` per-level tuples.
            gt_bboxes: (B, G, 4) zero-padded, xyxy; gt_labels: (B, G)
                0-based, arbitrary at padding; gt_valid: (B, G) bool.

        Returns:
            dict with ``loss_cls``, ``loss_bbox`` and ``num_gts``.
        """
        cls_scores, bbox_preds = preds
        _, anchors = self._anchors(cls_scores)
        b = cls_scores[0].shape[0]
        cls_flat = torch.cat([c.reshape(b, -1, self.num_classes).float()
                              for c in cls_scores], dim=1)  # (B, A, C)
        reg_flat = torch.cat([r.reshape(b, -1, 4).float()
                              for r in bbox_preds], dim=1)  # (B, A, 4)
        gt_bboxes = gt_bboxes.float()
        assigned = max_iou_assign_batch(
            anchors, gt_bboxes, gt_valid, self.pos_iou_thr,
            self.neg_iou_thr, self.min_pos_iou, True)  # (B, A)
        pos = assigned >= 0
        neg = assigned == NEGATIVE
        num_pos = torch.clamp_min(global_sum(pos.float().sum()), 1.0)
        gt_idx = assigned.clamp_min(0)
        matched_labels = torch.gather(gt_labels.long(), 1, gt_idx)
        onehot = L.one_hot(matched_labels, self.num_classes,
                           torch.float32) * pos[..., None]
        label_weights = (pos | neg).float()[..., None]
        if self.use_ghm:
            # GHM-C with 30 bins (configs/ghm/retinanet_ghm_r50_fpn_1x_coco)
            loss_cls = L.ghm_c_loss(
                cls_flat, onehot, bins=30,
                label_weight=label_weights.expand_as(cls_flat),
                loss_weight=self.loss_cls_weight)
        else:
            loss_cls = L.sigmoid_focal_loss(
                cls_flat, onehot, gamma=self.focal_gamma,
                alpha=self.focal_alpha, weight=label_weights,
                avg_factor=num_pos, loss_weight=self.loss_cls_weight)
        matched_boxes = torch.gather(gt_bboxes, 1,
                                     gt_idx[..., None].expand(-1, -1, 4))
        matched_boxes = torch.where(pos[..., None], matched_boxes,
                                    anchors[None])
        target_deltas = self.bbox_coder.encode(anchors[None], matched_boxes)
        if self.use_ghm:
            # GHM-R: mu 0.02, 10 bins, weight 10
            loss_bbox = L.ghm_r_loss(
                reg_flat, target_deltas,
                label_weight=pos[..., None].float().expand_as(reg_flat),
                mu=0.02, bins=10, loss_weight=10.0 * self.loss_bbox_weight)
        else:
            loss_bbox = L.l1_loss(reg_flat, target_deltas,
                                  weight=pos[..., None].float(),
                                  avg_factor=num_pos,
                                  loss_weight=self.loss_bbox_weight)
        num_gts = gt_valid.float().sum() / global_count(gt_valid.shape[0],
                                                        gt_valid.device)
        return dict(loss_cls=loss_cls, loss_bbox=loss_bbox, num_gts=num_gts)

    def get_bboxes(self, preds, scale_factors=None, score_thr: float = 0.05,
                   iou_thr: float = 0.5, max_per_img: int = 100,
                   nms_pre: int = 1000, img_shape=None, with_nms: bool = True,
                   nms_type: str = 'nms', sigma: float = 0.5,
                   min_score: float = 1e-3, method: str = 'linear',
                   **kwargs):
        """Per-level top-``nms_pre`` -> decode -> class-aware NMS
        (``retina_head.py:182-232``), batched, in fp32.

        Args:
            preds: ``(cls_scores, bbox_preds)`` per-level tuples.
            scale_factors: optional (B, 4); boxes are divided back to the
                original images.
            img_shape: optional ``(h, w)``, numbers or per-image (B, 1)
                columns: decoded boxes are clipped to it.

        Returns:
            NMSResult with (B, max_per_img, ...) padded detections; with
            ``with_nms=False`` ``(boxes (B, N, 4), scores (B, N, C + 1))``,
            the sigmoid scores and a zero background column.
        """
        cls_scores, bbox_preds = preds
        levels, _ = self._anchors(cls_scores)
        b = cls_scores[0].shape[0]
        all_boxes, all_scores = [], []
        for lvl, anchors in enumerate(levels):
            scores = torch.sigmoid(cls_scores[lvl].reshape(
                b, -1, self.num_classes).float())
            deltas = bbox_preds[lvl].reshape(b, -1, 4).float()
            n = scores.shape[1]
            k = min(nms_pre, n) if with_nms else 0
            if 0 < k < n:
                _, topk = topk_scores(scores.amax(dim=-1), k)
                scores = torch.gather(
                    scores, 1, topk[..., None].expand(-1, -1,
                                                      self.num_classes))
                deltas = torch.gather(deltas, 1,
                                      topk[..., None].expand(-1, -1, 4))
                lvl_anchors = anchors[topk]
            else:
                lvl_anchors = anchors[None].expand(b, -1, -1)
            all_boxes.append(self.bbox_coder.decode(lvl_anchors, deltas,
                                                    max_shape=img_shape))
            all_scores.append(scores)
        bbox = torch.cat(all_boxes, dim=1)
        scores = torch.cat(all_scores, dim=1)
        if scale_factors is not None:
            scale_factors = torch.as_tensor(scale_factors, dtype=bbox.dtype,
                                            device=bbox.device)
            bbox = bbox / scale_factors[:, None, :]
        if not with_nms:
            return bbox, F.pad(scores, (0, 1))
        return batched_nms(bbox, scores, score_thr, iou_thr, max_per_img,
                           nms_pre=min(4096, bbox.shape[1] *
                                       self.num_classes),
                           nms_type=nms_type, sigma=sigma,
                           min_score=min_score, method=method)
