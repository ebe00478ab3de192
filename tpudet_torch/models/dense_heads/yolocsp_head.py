"""YOLOv4/v5 dense head, inference: port of
``tpudet/models/dense_heads/yolocsp_head.py`` (``__call__``,
``decode_pred_maps``, ``_prefiltered_decode``, ``get_bboxes``).

One 1x1 conv with bias per level. Pred maps leave the head in tpudet's
layout, (B, H, W, A*attrib) with the anchor axis fastest, so they reshape
straight onto the anchor grid. Decode is batched and in fp32.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch
from torch import nn

from ...core.anchors import YOLOV4AnchorGenerator
from ...core.bbox import YOLOV4BBoxCoder
from ...core.nms import batched_class_lane_nms, topk_scores
from ...registry import HEADS

# COCO default anchors (reference yolocsp_head.py:83-90)
DEFAULT_BASE_SIZES = (
    ((12, 16), (19, 36), (40, 28)),  # P3/8
    ((36, 75), (76, 55), (72, 146)),  # P4/16
    ((142, 110), (192, 243), (459, 401)),  # P5/32
)


@HEADS.register_module()
class YOLOCSPHead(nn.Module):
    """COCO anchors at strides 8/16/32, class-aware (the configuration of
    every YOLOv4 config); 4 box + 1 objectness + ``num_classes`` logits per
    anchor."""

    base_sizes = DEFAULT_BASE_SIZES
    featmap_strides = (8, 16, 32)
    num_obj_avg = 8  # objectness prior: 8 objects per 640^2 image

    def __init__(self, num_classes: int, in_channels: Sequence[int]):
        super().__init__()
        self.num_classes = num_classes
        self.num_attrib = 5 + num_classes
        self.num_levels = len(self.featmap_strides)
        assert len(in_channels) == self.num_levels
        self.anchor_generator = YOLOV4AnchorGenerator(
            strides=list(self.featmap_strides),
            base_sizes=[list(b) for b in self.base_sizes])
        for i, cin in enumerate(in_channels):
            self.add_module(f'conv_pred{i}', nn.Conv2d(
                cin, len(self.base_sizes[i]) * self.num_attrib, 1))
        # anchor grids on the device, per (featmap sizes, device)
        self._grids: Dict = {}

    def bias_prior(self, level: int) -> np.ndarray:
        """tpudet's objectness/class bias init of ``conv_pred{level}``
        (reference init_weights :187-201)."""
        num_anchors = len(self.base_sizes[level])
        stride = self.featmap_strides[level]
        b = np.zeros((num_anchors, self.num_attrib), dtype=np.float32)
        b[:, 4] = math.log(self.num_obj_avg / (640 / stride)**2)
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
        cls."""
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
        return (torch.cat(boxes, dim=1), torch.cat(confs, dim=1),
                torch.cat(clss, dim=1))

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
        return boxes, sel[..., 4], sel[..., 5:]

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
                   nms_type: str = 'nms'):
        """Batched decode + class-aware NMS with lane budgets.

        ``anchor_pre`` keeps the top-k anchors by objectness before the
        class axis is flattened (``anchor_pre=0`` decodes every anchor).
        Decode does not clip to the image. ``nms_pre`` belongs to NMS
        branches not ported yet.

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
        scores = cls * conf[..., None]
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
        raise NotImplementedError(
            f'get_bboxes: only the lane-budgeted NMS (lane_pre > 0, '
            f"nms_type='nms') is ported; nms_type={nms_type!r}, "
            f'lane_pre={lane_pre}, class_pre={class_pre}, nms_pre={nms_pre} '
            f'comes with ROADMAP.md\'s "other NMS branches" item')
