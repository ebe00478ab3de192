"""YOLOv3's head: port of ``tpudet/models/dense_heads/yolov3_head.py``.

Per level, deepest first (strides 32, 16, 8): a 3x3 bridge conv
(``conv_bridge{i}``, Darknet's conv + BN + LeakyReLU(0.1)) and a 1x1
prediction conv with bias (``conv_pred{i}``, N(0, 0.01^2) kernel, zero
bias) to (B, H, W, A * (5 + C)), the anchor axis fastest.

- ``loss``: one GridAssigner pass over all levels' anchors together
  (each gt's forced best anchor is one anchor of the whole pyramid), the
  anchors responsible for a gt being those of the cell holding its centre;
  BCE for the classes, the objectness and the in-cell xy offsets, squared
  error for the log wh scales, weights 1 / 1 / 2 / 2; tpudet's
  ``loss_reduction='sum'`` sums the elements, ``'mean'`` divides by the
  element counts of every rank's batch;
- ``get_bboxes``: sigmoid xy, objectness and classes, the YOLO coder,
  the objectness zeroed under ``conf_thr``, the top ``nms_pre`` of each
  level by objectness, scores ``cls * conf``, then ``batched_nms`` over
  the 4096 best pairs; with ``with_nms=False`` the raw candidates.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...core.anchors import YOLOAnchorGenerator
from ...core.assigners import NEGATIVE, grid_assign_batch
from ...core.bbox import YOLOBBoxCoder
from ...core.nms import _gather_rows, batched_nms, topk_scores
from ...parallel.mesh import global_count
from ...registry import HEADS
from .. import losses as L
from ..backbones.darknet import conv_module
from ..layers import Conv

# COCO anchors, deepest level first (tpudet yolov3_head.py:34-39)
V3_BASE_SIZES = (
    ((116, 90), (156, 198), (373, 326)),
    ((30, 61), (62, 45), (59, 119)),
    ((10, 13), (16, 30), (33, 23)),
)


@HEADS.register_module()
class YOLOV3Head(nn.Module):
    """The keyword arguments are tpudet's fields (``yolov3_head.py:42-62``)
    with its defaults."""

    def __init__(self, num_classes: int,
                 in_channels: Sequence[int] = (512, 256, 128),
                 out_channels: Sequence[int] = (1024, 512, 256),
                 base_sizes: Sequence = V3_BASE_SIZES,
                 featmap_strides: Sequence[int] = (32, 16, 8),
                 one_hot_smoother: float = 0., pos_iou_thr: float = 0.5,
                 neg_iou_thr: float = 0.5, loss_cls_weight: float = 1.0,
                 loss_conf_weight: float = 1.0, loss_xy_weight: float = 2.0,
                 loss_wh_weight: float = 2.0, loss_reduction: str = 'sum',
                 dtype=None):
        super().__init__()
        if dtype is not None:
            raise ValueError(f'YOLOV3Head: dtype={dtype!r} is not a module '
                             f'setting in the port; see '
                             f'SingleStageDetector.set_dtype')
        self.num_classes = num_classes
        self.num_attrib = 5 + num_classes
        self.base_sizes = tuple(tuple(tuple(b) for b in level)
                                for level in base_sizes)
        self.featmap_strides = tuple(featmap_strides)
        self.num_levels = len(self.featmap_strides)
        self.one_hot_smoother = one_hot_smoother
        self.pos_iou_thr = pos_iou_thr
        self.neg_iou_thr = neg_iou_thr
        self.loss_cls_weight = loss_cls_weight
        self.loss_conf_weight = loss_conf_weight
        self.loss_xy_weight = loss_xy_weight
        self.loss_wh_weight = loss_wh_weight
        self.loss_reduction = loss_reduction
        self.anchor_generator = YOLOAnchorGenerator(
            strides=list(self.featmap_strides),
            base_sizes=[list(b) for b in self.base_sizes])
        for i in range(self.num_levels):
            self.add_module(f'conv_bridge{i}', conv_module(
                in_channels[i], out_channels[i], 3))
            self.add_module(f'conv_pred{i}', Conv(
                out_channels[i], len(self.base_sizes[i]) * self.num_attrib, 1,
                kernel_init=('normal', 0.01)))
        # anchor grids on the device, per (featmap sizes, device)
        self._grids: Dict = {}

    def forward(self, feats):
        """NCHW features, deepest first -> per-level (B, H, W, A*attrib)
        raw pred maps."""
        assert len(feats) == self.num_levels
        return tuple(
            getattr(self, f'conv_pred{i}')(
                getattr(self, f'conv_bridge{i}')(f)).permute(0, 2, 3, 1)
            for i, f in enumerate(feats))

    def _grid(self, pred_maps):
        """Per-level anchors (H*W*A, 4) on the pred maps' device."""
        sizes = tuple(tuple(p.shape[1:3]) for p in pred_maps)
        key = (sizes, pred_maps[0].device)
        if key not in self._grids:
            self._grids[key] = [
                torch.from_numpy(a).to(pred_maps[0].device)
                for a in self.anchor_generator.grid_anchors(sizes)]
        return self._grids[key]

    def _responsible(self, gt_bboxes, gt_valid, featmap_size, stride,
                     num_anchors):
        """(B, H*W*A): the anchors of each cell that holds a valid gt's
        centre, the cell index truncated toward zero and clipped to the
        map (``yolov3_head.py:100-110``)."""
        feat_h, feat_w = featmap_size
        cx = (gt_bboxes[..., 0] + gt_bboxes[..., 2]) * 0.5
        cy = (gt_bboxes[..., 1] + gt_bboxes[..., 3]) * 0.5
        gx = (cx / stride).to(torch.int64).clamp(0, feat_w - 1)
        gy = (cy / stride).to(torch.int64).clamp(0, feat_h - 1)
        grid = torch.zeros(gt_valid.shape[0], feat_h * feat_w,
                           dtype=torch.int32, device=gt_valid.device)
        grid = grid.scatter_reduce(1, gy * feat_w + gx, gt_valid.int(),
                                   'amax')
        return (grid > 0).repeat_interleave(num_anchors, dim=1)

    def loss(self, pred_maps, gt_bboxes, gt_labels, gt_valid
             ) -> Dict[str, torch.Tensor]:
        """The loss dict (fp32) of the pred maps against padded gts
        (``yolov3_head.py:112-188``)."""
        levels = self._grid(pred_maps)
        gt_bboxes = gt_bboxes.float()
        sizes = [tuple(p.shape[1:3]) for p in pred_maps]
        responsible = torch.cat([
            self._responsible(gt_bboxes, gt_valid, sizes[i],
                              float(self.featmap_strides[i]),
                              len(self.base_sizes[i]))
            for i in range(self.num_levels)], dim=1)
        flat_assigned = grid_assign_batch(
            torch.cat(levels), responsible, gt_bboxes, gt_valid,
            self.pos_iou_thr, self.neg_iou_thr, 0.0)
        coder = YOLOBBoxCoder()
        b = gt_valid.shape[0]
        total = dict(loss_cls=0., loss_conf=0., loss_xy=0., loss_wh=0.)
        start = 0
        for lvl, pred in enumerate(pred_maps):
            pred = pred.float().reshape(b, -1, self.num_attrib)
            n = pred.shape[1]
            anchors = levels[lvl]
            assigned = flat_assigned[:, start:start + n]
            start += n
            pos = (assigned >= 0).float()
            neg = (assigned == NEGATIVE).float()
            gt_idx = assigned.clamp_min(0)
            matched = torch.where(pos[..., None] > 0,
                                  _gather_rows(gt_bboxes, gt_idx),
                                  anchors[None].expand(b, n, 4))
            target = coder.encode(anchors[None], matched,
                                  float(self.featmap_strides[lvl]))
            labels = torch.gather(gt_labels.long(), 1, gt_idx)
            tcls = F.one_hot(labels.clamp(0, self.num_classes - 1),
                             self.num_classes).float()
            if self.one_hot_smoother != 0:
                tcls = tcls * (1 - self.one_hot_smoother) + \
                    self.one_hot_smoother / self.num_classes
            if self.loss_reduction == 'sum':
                numel_cls = numel_1 = numel_2 = 1.0
            else:  # every rank's elements
                images = global_count(b, pred.device)
                numel_cls = images * n * self.num_classes
                numel_1 = images * n
                numel_2 = images * n * 2
            total['loss_cls'] += L.bce_loss(
                pred[..., 5:], tcls, weight=pos[..., None],
                avg_factor=numel_cls, loss_weight=self.loss_cls_weight)
            total['loss_conf'] += L.bce_loss(
                pred[..., 4], pos, weight=torch.clamp(pos + neg, 0., 1.),
                avg_factor=numel_1, loss_weight=self.loss_conf_weight)
            total['loss_xy'] += L.bce_loss(
                pred[..., :2], target[..., :2], weight=pos[..., None],
                avg_factor=numel_2, loss_weight=self.loss_xy_weight)
            mse = (pred[..., 2:4] - target[..., 2:4]) ** 2
            total['loss_wh'] += self.loss_wh_weight * (
                mse * pos[..., None]).sum() / numel_2
        total['num_gts'] = gt_valid.float().sum() / global_count(
            b, gt_valid.device)
        return total

    def get_bboxes(self, pred_maps, scale_factors=None,
                   score_thr: float = 0.05, conf_thr: float = 0.005,
                   iou_thr: float = 0.45, max_per_img: int = 100,
                   nms_pre: int = 1000, img_shape=None,
                   with_nms: bool = True, **kwargs):
        """Detections (``NMSResult``, (B, max_per_img, ...), boxes divided
        by ``scale_factors`` (B, 4), not clipped: ``img_shape`` is not
        read, as tpudet's); with ``with_nms=False`` ``(bboxes (B, N, 4),
        scores (B, N, C + 1) with a zero background column, conf (B,
        N))`` of every anchor."""
        levels = self._grid(pred_maps)
        boxes_all, scores_all, conf_all = [], [], []
        for lvl, pred in enumerate(pred_maps):
            b = pred.shape[0]
            p = pred.reshape(b, -1, self.num_attrib).float()
            xy = torch.sigmoid(p[..., :2])
            conf = torch.sigmoid(p[..., 4])
            cls = torch.sigmoid(p[..., 5:])
            decoded = YOLOBBoxCoder.decode(
                levels[lvl][None], torch.cat([xy, p[..., 2:4]], dim=-1),
                float(self.featmap_strides[lvl]))
            if not with_nms:
                boxes_all.append(decoded)
                scores_all.append(cls)
                conf_all.append(conf)
                continue
            conf = torch.where(conf >= conf_thr, conf, torch.zeros_like(conf))
            k = min(nms_pre, decoded.shape[1])
            if 0 < k < decoded.shape[1]:
                conf, top = topk_scores(conf, k)
                decoded = _gather_rows(decoded, top)
                cls = _gather_rows(cls, top)
            boxes_all.append(decoded)
            scores_all.append(cls * conf[..., None])
        bbox = torch.cat(boxes_all, dim=1)
        scores = torch.cat(scores_all, dim=1)
        if scale_factors is not None:
            bbox = bbox / torch.as_tensor(scale_factors, dtype=bbox.dtype,
                                          device=bbox.device)[:, None, :]
        if not with_nms:
            return (bbox, F.pad(scores, (0, 1)), torch.cat(conf_all, dim=1))
        return batched_nms(bbox, scores, score_thr, iou_thr, max_per_img,
                           nms_pre=4096)
