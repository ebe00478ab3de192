"""YOLOv4/v5 dense head: port of
``tpudet/models/dense_heads/yolocsp_head.py`` (``__call__``,
``decode_pred_maps``, ``_prefiltered_decode``, ``get_bboxes``, ``loss``).

One 1x1 conv with bias per level. Pred maps leave the head in tpudet's
layout, (B, H, W, A*attrib) with the anchor axis fastest, so they reshape
straight onto the anchor grid. Decode is batched and in fp32; so is the
loss, over tpudet's dense padded match slots (``core/targets.py``).
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch
from torch import nn

from ...core.anchors import YOLOV4AnchorGenerator
from ...core.bbox import YOLOV4BBoxCoder
from ...core.nms import (batched_class_lane_nms, batched_class_sorted_nms,
                         batched_dense_class_nms, batched_nms, topk_scores)
from ...core.targets import responsible_matches
from ...parallel.mesh import global_count, global_sum
from ...registry import HEADS
from .. import losses as L
from ..layers import Conv

# COCO default anchors (reference yolocsp_head.py:83-90)
DEFAULT_BASE_SIZES = (
    ((12, 16), (19, 36), (40, 28)),  # P3/8
    ((36, 75), (76, 55), (72, 146)),  # P4/16
    ((142, 110), (192, 243), (459, 401)),  # P5/32
)


@HEADS.register_module()
class YOLOCSPHead(nn.Module):
    """4 box + 1 objectness + ``num_classes`` logits per anchor (objectness
    only with ``class_agnostic``). The keyword arguments are tpudet's fields
    (``yolocsp_head.py:48-62``), with its defaults: COCO anchors at strides
    8/16/32, class-aware."""

    def __init__(self, num_classes: int, in_channels: Sequence[int],
                 base_sizes: Sequence = DEFAULT_BASE_SIZES,
                 featmap_strides: Sequence[int] = (8, 16, 32),
                 one_hot_smoother: float = 0.,
                 class_agnostic: bool = False,
                 shape_match_thres: float = 4.,
                 conf_iou_loss_ratio: float = 1.,
                 conf_level_balance: Sequence[float] = (4.0, 1.0, 0.4, 0.1,
                                                        0.1),
                 num_obj_avg: int = 8,
                 loss_cls_weight: float = 32.,
                 loss_conf_weight: float = 64.,
                 loss_bbox_weight: float = 3.2):
        super().__init__()
        self.num_classes = num_classes
        self.base_sizes = tuple(tuple(tuple(b) for b in level)
                                for level in base_sizes)
        self.featmap_strides = tuple(featmap_strides)
        self.one_hot_smoother = one_hot_smoother
        self.class_agnostic = class_agnostic
        self.shape_match_thres = shape_match_thres
        self.conf_iou_loss_ratio = conf_iou_loss_ratio
        self.conf_level_balance = tuple(conf_level_balance)
        self.num_obj_avg = num_obj_avg  # objectness prior per 640^2 image
        self.loss_cls_weight = loss_cls_weight
        self.loss_conf_weight = loss_conf_weight
        self.loss_bbox_weight = loss_bbox_weight
        self.num_attrib = 5 if class_agnostic else 5 + num_classes
        self.num_levels = len(self.featmap_strides)
        assert len(in_channels) == self.num_levels
        self.anchor_generator = YOLOV4AnchorGenerator(
            strides=list(self.featmap_strides),
            base_sizes=[list(b) for b in self.base_sizes])
        for i, cin in enumerate(in_channels):
            self.add_module(f'conv_pred{i}', Conv(
                cin, len(self.base_sizes[i]) * self.num_attrib, 1,
                kernel_init=('normal', 0.01), bias_init=self.bias_prior(i)))
        # anchor grids on the device, per (featmap sizes, device)
        self._grids: Dict = {}

    def bias_prior(self, level: int) -> np.ndarray:
        """tpudet's objectness/class bias init of ``conv_pred{level}``
        (reference init_weights :187-201)."""
        num_anchors = len(self.base_sizes[level])
        stride = self.featmap_strides[level]
        b = np.zeros((num_anchors, self.num_attrib), dtype=np.float32)
        b[:, 4] = math.log(self.num_obj_avg / (640 / stride)**2)
        if not self.class_agnostic:
            b[:, 5:] = math.log(0.6 / (self.num_classes - 0.99))
        return b.reshape(-1)

    def forward(self, feats):
        """NCHW features -> per-level (B, H, W, A*attrib) raw pred maps."""
        assert len(feats) == self.num_levels
        return tuple(
            getattr(self, f'conv_pred{i}')(f).permute(0, 2, 3, 1)
            for i, f in enumerate(feats))

    # ------------------------------------------------------------------
    # decode / test path (functions of the pred maps)
    # ------------------------------------------------------------------

    def _grid(self, pred_maps):
        """Per-level anchors, and all levels' anchors (N, 4) and strides
        (N,), on the pred maps' device."""
        sizes = tuple(tuple(p.shape[1:3]) for p in pred_maps)
        key = (sizes, pred_maps[0].device)
        if key not in self._grids:
            dev = pred_maps[0].device
            levels = self.anchor_generator.grid_anchors(sizes)
            strides = np.concatenate([
                np.full((len(a),), float(s), np.float32)
                for a, s in zip(levels, self.featmap_strides)])
            self._grids[key] = (
                [torch.from_numpy(a).to(dev) for a in levels],
                torch.from_numpy(np.concatenate(levels)).to(dev),
                torch.from_numpy(strides).to(dev))
        return self._grids[key]

    @staticmethod
    def _transform(p):
        """sigmoid'ed raw attribs -> coder input: ``xy*2-1``, ``(wh*2)^2``."""
        xy = p[..., 0:2] * 2.0 - 1.0
        wh = p[..., 2:4] * 2.0
        return torch.cat([xy, wh * wh], dim=-1)

    def decode_pred_maps(self, pred_maps):
        """All-level decode to (B, N, 4) boxes, (B, N) conf, (B, N, C)
        cls (None with ``class_agnostic``)."""
        levels, _, _ = self._grid(pred_maps)
        boxes, confs, clss = [], [], []
        for lvl, pred in enumerate(pred_maps):
            b = pred.shape[0]
            p = torch.sigmoid(pred.reshape(b, -1, self.num_attrib).float())
            boxes.append(YOLOV4BBoxCoder.decode(
                levels[lvl][None], self._transform(p),
                float(self.featmap_strides[lvl])))
            confs.append(p[..., 4])
            clss.append(p[..., 5:])
        cls = None if self.class_agnostic else torch.cat(clss, dim=1)
        return torch.cat(boxes, dim=1), torch.cat(confs, dim=1), cls

    def _prefiltered_decode(self, pred_maps, anchor_pre: int):
        """Objectness top-k in logit space, then decode only the kept
        anchors (sigmoid is monotonic, so the ranking is the same as
        decoding everything first)."""
        _, anchors, strides = self._grid(pred_maps)
        b = pred_maps[0].shape[0]
        raw = torch.cat(
            [p.reshape(b, -1, self.num_attrib) for p in pred_maps], dim=1)
        _, top_idx = topk_scores(raw[..., 4].float(), anchor_pre)  # (B, K)
        sel = torch.gather(
            raw, 1, top_idx[..., None].expand(b, top_idx.shape[1],
                                              self.num_attrib))
        sel = torch.sigmoid(sel.float())
        boxes = YOLOV4BBoxCoder.decode(anchors[top_idx], self._transform(sel),
                                       strides[top_idx])
        return (boxes, sel[..., 4],
                None if self.class_agnostic else sel[..., 5:])

    def get_bboxes(self,
                   pred_maps,
                   scale_factors=None,
                   score_thr: float = 0.001,
                   iou_thr: float = 0.65,
                   max_per_img: int = 300,
                   nms_pre: int = 2048,
                   anchor_pre: int = 2048,
                   class_pre: int = 0,
                   lane_pre: int = 0,
                   with_nms: bool = True,
                   nms_type: str = 'nms',
                   sigma: float = 0.5,
                   min_score: float = 1e-3,
                   method: str = 'linear',
                   **kwargs):
        """Batched decode + class-aware NMS, by tpudet's branches
        (``yolocsp_head.py:233-262``): lane budgets (``lane_pre > 0``),
        per-class budgets (``class_pre > 0``), the exact uncapped per-class
        NMS (``nms_pre <= 0``), else the flat top-``nms_pre`` NMS, soft with
        ``nms_type='soft_nms'`` (``sigma``, ``min_score``, ``method``).

        ``anchor_pre`` keeps the top-k anchors by objectness before the
        class axis is flattened (``anchor_pre=0`` decodes every anchor).
        Decode does not clip to the image: ``**kwargs`` absorbs the
        ``img_shape`` that the shared eval path passes, as tpudet's head
        does.

        Args:
            pred_maps: per-level (B, H, W, A*attrib) raw outputs.
            scale_factors: optional (B, 4) letterbox scale factors; boxes
                are then divided back to original image space.

        Returns:
            NMSResult with (B, max_per_img, ...) padded detections, or
            ``(bboxes, scores)`` before NMS when ``with_nms`` is False.
        """
        num_anchors = sum(
            int(np.prod(p.shape[1:3])) * len(self.base_sizes[lvl])
            for lvl, p in enumerate(pred_maps))
        if 0 < anchor_pre < num_anchors:
            bbox, conf, cls = self._prefiltered_decode(pred_maps, anchor_pre)
        else:
            bbox, conf, cls = self.decode_pred_maps(pred_maps)
        # class-agnostic: the objectness is the one score
        scores = conf[..., None] if cls is None else cls * conf[..., None]
        if scale_factors is not None:
            scale_factors = torch.as_tensor(scale_factors, dtype=bbox.dtype,
                                            device=bbox.device)
            bbox = bbox / scale_factors[:, None, :]
        if not with_nms:
            return bbox, scores
        if nms_type == 'nms' and lane_pre > 0:
            return batched_class_lane_nms(bbox, scores, score_thr, iou_thr,
                                          max_per_img, lane_pre=lane_pre,
                                          class_pre=class_pre)
        if nms_type == 'nms' and class_pre > 0:
            return batched_class_sorted_nms(bbox, scores, score_thr, iou_thr,
                                            max_per_img, class_pre=class_pre)
        if nms_type == 'nms' and nms_pre <= 0:
            return batched_dense_class_nms(bbox, scores, score_thr, iou_thr,
                                           max_per_img)
        total = scores.shape[1] * scores.shape[2]
        return batched_nms(bbox, scores, score_thr, iou_thr, max_per_img,
                           nms_pre=total if nms_pre <= 0 else min(nms_pre,
                                                                  total),
                           nms_type=nms_type, sigma=sigma,
                           min_score=min_score, method=method)

    # ------------------------------------------------------------------
    # training loss (assigner-free path)
    # ------------------------------------------------------------------

    def loss(self, pred_maps, gt_bboxes, gt_labels, gt_valid
             ) -> Dict[str, torch.Tensor]:
        """Assigner-free YOLOv5-style loss over dense padded targets
        (``tpudet/models/dense_heads/yolocsp_head.py:268-355``), in fp32.

        Args:
            pred_maps: per-level (B, H, W, A*attrib) raw outputs.
            gt_bboxes: (B, G, 4) zero-padded gt boxes, xyxy image coords.
            gt_labels: (B, G) int class ids (0-based), arbitrary at padding.
            gt_valid: (B, G) bool.

        Returns:
            dict with loss_cls / loss_conf / loss_bbox scalars (weighted and
            level-balanced, ready to sum) and num_gts. While a process
            group is open, each is this rank's share: its sums over the
            counts of every rank's batch (``parallel.global_sum``), so the
            ranks' shares add up to tpudet's value on the whole batch.
        """
        levels, _, _ = self._grid(pred_maps)
        anchor_whs = self.anchor_generator.base_anchor_wh()
        gt_bboxes = gt_bboxes.float()
        classes = torch.arange(self.num_classes, device=gt_labels.device)
        # a 0-d tensor: with class_agnostic no class term adds to it
        total_cls = gt_bboxes.new_zeros(())
        total_conf = total_bbox = 0.
        for lvl, pred in enumerate(pred_maps):
            b = pred.shape[0]
            pred = pred.float().reshape(b, -1, self.num_attrib)
            stride = float(self.featmap_strides[lvl])
            matches = responsible_matches(
                gt_bboxes, gt_valid, tuple(pred_maps[lvl].shape[1:3]),
                stride, anchor_whs[lvl], neighbor=2,
                shape_match_thres=self.shape_match_thres)
            idx = matches.anchor_idx.reshape(b, -1)  # (B, M)
            mask = matches.mask.reshape(b, -1).float()
            slots_per_gt = idx.shape[1] // gt_bboxes.shape[1]

            pred_pos = torch.gather(
                pred, 1, idx[..., None].expand(-1, -1, self.num_attrib))
            # decode the positives
            pbox = YOLOV4BBoxCoder.decode(
                levels[lvl][idx], self._transform(torch.sigmoid(
                    pred_pos[..., :4])), stride)
            # slot (g, a, o) -> gt g
            tbox = gt_bboxes.repeat_interleave(slots_per_gt, dim=1)
            tlabel = gt_labels.repeat_interleave(slots_per_gt, dim=1)

            giou_l = L.giou_loss(pbox, tbox, reduction='none')  # (B, M)
            # the positives and the conf terms of every rank's batch
            num_pos, num_conf = global_sum(torch.stack([
                mask.sum(), mask.new_tensor(float(pred.shape[0] *
                                                  pred.shape[1]))]))
            num_pos = torch.clamp_min(num_pos, 1.0)
            total_bbox = total_bbox + ((giou_l * mask).sum() / num_pos *
                                       self.loss_bbox_weight)

            if not self.class_agnostic:
                # one-hot with zero rows for out-of-range (padding) labels,
                # as jax.nn.one_hot gives
                tcls = (tlabel[..., None] == classes).float()
                if self.one_hot_smoother != 0:
                    tcls = (tcls * (1 - self.one_hot_smoother) +
                            self.one_hot_smoother / self.num_classes)
                cls_bce = L.binary_cross_entropy_with_logits(
                    pred_pos[..., 5:], tcls)
                total_cls = total_cls + ((cls_bce * mask[..., None]).sum() /
                                         (num_pos * self.num_classes) *
                                         self.loss_cls_weight)

            # IoU-aware conf target, scatter-max over the slots that land
            # on one anchor; no gradient flows through it
            r = self.conf_iou_loss_ratio
            conf_t = ((1 - r) + r * torch.clamp(1.0 - giou_l.detach(), 0.0,
                                                1.0)) * mask
            target_conf = torch.zeros_like(pred[..., 4]).scatter_reduce(
                1, idx, conf_t, 'amax', include_self=True)
            conf_bce = L.binary_cross_entropy_with_logits(pred[..., 4],
                                                          target_conf)
            total_conf = total_conf + (conf_bce.sum() / num_conf *
                                       self.loss_conf_weight *
                                       self.conf_level_balance[lvl])

        num_gts = gt_valid.float().sum() / global_count(gt_valid.shape[0],
                                                        gt_valid.device)
        return dict(loss_cls=total_cls, loss_conf=total_conf,
                    loss_bbox=total_bbox, num_gts=num_gts)
