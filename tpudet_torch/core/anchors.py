"""Anchor grids, numpy: the port's own copy of ``tpudet/core/anchors.py``'s
``AnchorGenerator`` (``:34-153``, RetinaNet's), ``SSDAnchorGenerator``
(``:157-218``), ``YOLOAnchorGenerator`` (``:221-275``: grid anchors, base
anchor sizes, ``responsible_flags``) and ``YOLOV4AnchorGenerator``, its
subclass.

Base anchors are xyxy around a per-level centre (the grid corner for
``AnchorGenerator``, stride/2 for YOLO); grid anchors shift them by
(x*stride_w, y*stride_h), row-major with the base-anchor axis fastest, so
NHWC pred maps reshape directly onto the anchor axis.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np


def _pair(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x, x)


def _level_grid(base_anchors, featmap_size, stride) -> np.ndarray:
    """Base anchors shifted over an (H, W) grid: (H*W*A, 4) float32."""
    feat_h, feat_w = featmap_size
    shift_x = np.arange(0, feat_w, dtype=np.float32) * stride[0]
    shift_y = np.arange(0, feat_h, dtype=np.float32) * stride[1]
    xx = np.tile(shift_x, feat_h)
    yy = np.repeat(shift_y, feat_w)
    shifts = np.stack([xx, yy, xx, yy], axis=-1)
    anchors = base_anchors[None, :, :] + shifts[:, None, :]
    return anchors.reshape(-1, 4).astype(np.float32)


class AnchorGenerator:
    """The multi-level anchor generator of RetinaNet: ``base_sizes``
    default to min(stride); scales come from ``scales`` or from
    ``octave_base_scale`` and ``scales_per_octave``; ratios are h/w;
    ``center_offset`` 0 puts the centre on the grid corner."""

    def __init__(self, strides, ratios, scales=None, base_sizes=None,
                 scale_major=True, octave_base_scale=None,
                 scales_per_octave=None, centers=None, center_offset=0.):
        if center_offset != 0:
            assert centers is None
        assert 0 <= center_offset <= 1
        self.strides = [_pair(s) for s in strides]
        self.base_sizes = ([min(s) for s in self.strides]
                           if base_sizes is None else list(base_sizes))
        assert len(self.base_sizes) == len(self.strides)
        assert ((octave_base_scale is not None
                 and scales_per_octave is not None) ^ (scales is not None))
        if scales is not None:
            self.scales = np.asarray(scales, dtype=np.float32)
        else:
            octave_scales = np.array(
                [2**(i / scales_per_octave) for i in range(scales_per_octave)])
            self.scales = (octave_scales * octave_base_scale).astype(
                np.float32)
        self.octave_base_scale = octave_base_scale
        self.scales_per_octave = scales_per_octave
        self.ratios = np.asarray(ratios, dtype=np.float32)
        self.scale_major = scale_major
        self.centers = centers
        self.center_offset = center_offset
        self.base_anchors = [
            self._single_level_base_anchors(
                base, self.centers[i] if self.centers is not None else None)
            for i, base in enumerate(self.base_sizes)]

    @property
    def num_base_anchors(self) -> List[int]:
        return [a.shape[0] for a in self.base_anchors]

    @property
    def num_levels(self) -> int:
        return len(self.strides)

    def _single_level_base_anchors(self, base_size, center=None,
                                   scales=None, ratios=None) -> np.ndarray:
        """A level's base anchors from ``scales`` and ``ratios`` (the
        generator's own unless given)."""
        scales = self.scales if scales is None else scales
        ratios = self.ratios if ratios is None else ratios
        w = h = float(base_size)
        if center is None:
            x_center = self.center_offset * w
            y_center = self.center_offset * h
        else:
            x_center, y_center = center
        h_ratios = np.sqrt(ratios)
        w_ratios = 1.0 / h_ratios
        if self.scale_major:
            ws = (w * w_ratios[:, None] * scales[None, :]).reshape(-1)
            hs = (h * h_ratios[:, None] * scales[None, :]).reshape(-1)
        else:
            ws = (w * scales[:, None] * w_ratios[None, :]).reshape(-1)
            hs = (h * scales[:, None] * h_ratios[None, :]).reshape(-1)
        return np.stack([x_center - 0.5 * ws, y_center - 0.5 * hs,
                         x_center + 0.5 * ws, y_center + 0.5 * hs],
                        axis=-1).astype(np.float32)

    def grid_anchors(self, featmap_sizes: Sequence[Tuple[int, int]]
                     ) -> List[np.ndarray]:
        """Anchors per level, shape (H*W*A, 4), row-major, A fastest."""
        assert len(featmap_sizes) == self.num_levels
        return [_level_grid(self.base_anchors[i], featmap_sizes[i],
                            self.strides[i]) for i in range(self.num_levels)]

    def valid_flags(self, featmap_sizes, pad_shape) -> List[np.ndarray]:
        """Validity of each anchor against the padded image (H, W)."""
        out = []
        for i in range(self.num_levels):
            feat_h, feat_w = featmap_sizes[i]
            h, w = pad_shape[:2]
            valid_h = min(int(math.ceil(h / self.strides[i][1])), feat_h)
            valid_w = min(int(math.ceil(w / self.strides[i][0])), feat_w)
            vx = np.zeros(feat_w, dtype=bool)
            vy = np.zeros(feat_h, dtype=bool)
            vx[:valid_w] = True
            vy[:valid_h] = True
            valid = (vy[:, None] & vx[None, :]).reshape(-1)
            out.append(np.repeat(valid, self.num_base_anchors[i]))
        return out


class SSDAnchorGenerator(AnchorGenerator):
    """SSD's generator: per-level min and max sizes from
    ``basesize_ratio_range`` (the first level from tpudet's table of
    ``(input_size, min ratio)`` pairs; others raise ``ValueError``), scales
    ``[1, sqrt(max / min)]``, ratios ``[1, 1/r, r, ...]``, centres at
    stride/2, and the big square anchor (the last row) moved to slot 1."""

    def __init__(self, strides, ratios, basesize_ratio_range,
                 input_size=300, scale_major=True):
        assert len(strides) == len(ratios)
        self.strides = [_pair(s) for s in strides]
        self.input_size = input_size
        self.centers = [(s[0] / 2., s[1] / 2.) for s in self.strides]
        self.basesize_ratio_range = basesize_ratio_range

        min_ratio, max_ratio = basesize_ratio_range
        min_ratio = int(min_ratio * 100)
        max_ratio = int(max_ratio * 100)
        step = int(np.floor(max_ratio - min_ratio) / (self.num_levels - 2))
        min_sizes, max_sizes = [], []
        for ratio in range(min_ratio, max_ratio + 1, step):
            min_sizes.append(int(input_size * ratio / 100))
            max_sizes.append(int(input_size * (ratio + step) / 100))
        first = {  # (input_size, min_ratio_percent) -> head sizes
            (300, 15): (7, 15), (300, 20): (10, 20),
            (512, 10): (4, 10), (512, 15): (7, 15),
        }.get((input_size, min_ratio))
        if first is None:
            raise ValueError(
                f'unsupported SSD config ({input_size}, {min_ratio / 100})')
        min_sizes.insert(0, int(input_size * first[0] / 100))
        max_sizes.insert(0, int(input_size * first[1] / 100))

        self.base_sizes = min_sizes
        self.scales = []
        self.ratios = []
        for k in range(len(self.strides)):
            self.scales.append(
                np.array([1., np.sqrt(max_sizes[k] / min_sizes[k])],
                         np.float32))
            anchor_ratio = [1.]
            for r in ratios[k]:
                anchor_ratio += [1 / r, r]
            self.ratios.append(np.array(anchor_ratio, np.float32))
        self.scale_major = scale_major
        self.center_offset = 0
        self.base_anchors = []
        for i, base_size in enumerate(self.base_sizes):
            anchors = self._single_level_base_anchors(
                base_size, self.centers[i], self.scales[i], self.ratios[i])
            indices = list(range(len(self.ratios[i])))
            indices.insert(1, len(indices))
            self.base_anchors.append(anchors[indices])


class YOLOAnchorGenerator:
    """Explicit per-level (w, h) base sizes, centres at stride/2."""

    def __init__(self, strides, base_sizes):
        self.strides = [_pair(s) for s in strides]
        self.centers = [(s[0] / 2., s[1] / 2.) for s in self.strides]
        num_anchor_per_level = len(base_sizes[0])
        self.base_sizes = []
        for per_level in base_sizes:
            assert num_anchor_per_level == len(per_level)
            self.base_sizes.append([_pair(b) for b in per_level])
        self.base_anchors = []
        for (cx, cy), per_level in zip(self.centers, self.base_sizes):
            self.base_anchors.append(np.array(
                [[cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h]
                 for (w, h) in per_level], dtype=np.float32))

    @property
    def num_levels(self) -> int:
        return len(self.base_sizes)

    @property
    def num_base_anchors(self) -> List[int]:
        return [a.shape[0] for a in self.base_anchors]

    def base_anchor_wh(self) -> List[np.ndarray]:
        """(A, 2) widths/heights of the base anchors, per level
        (``tpudet/core/anchors.py:249-254``)."""
        return [np.stack([a[:, 2] - a[:, 0], a[:, 3] - a[:, 1]], axis=-1)
                for a in self.base_anchors]

    def grid_anchors(self, featmap_sizes: Sequence[Tuple[int, int]]
                     ) -> List[np.ndarray]:
        """Anchors per level, shape (H*W*A, 4), row-major, A fastest."""
        assert len(featmap_sizes) == self.num_levels
        return [_level_grid(base, size, stride) for base, size, stride in
                zip(self.base_anchors, featmap_sizes, self.strides)]

    def responsible_flags(self, featmap_sizes, gt_bboxes) -> List[np.ndarray]:
        """YOLOv3's single-cell responsibility of one image's gts (G, 4):
        per level, (H*W*A,) True for every anchor of a cell that holds a gt
        centre (``tpudet/core/anchors.py:256-275``)."""
        assert self.num_levels == len(featmap_sizes)
        out = []
        for i in range(self.num_levels):
            feat_h, feat_w = featmap_sizes[i]
            sx, sy = self.strides[i]
            cx = (gt_bboxes[:, 0] + gt_bboxes[:, 2]) * 0.5
            cy = (gt_bboxes[:, 1] + gt_bboxes[:, 3]) * 0.5
            gx = np.floor(cx / sx).astype(np.int64)
            gy = np.floor(cy / sy).astype(np.int64)
            grid = np.zeros(feat_h * feat_w, dtype=bool)
            grid[gy * feat_w + gx] = True
            out.append(np.repeat(grid, self.num_base_anchors[i]))
        return out


class YOLOV4AnchorGenerator(YOLOAnchorGenerator):
    """YOLOv4/v5's generator: YOLOv3's grid. tpudet's subclass adds only
    the reference's variable-length matcher, which both packages compute
    densely in ``core/targets.py``."""
