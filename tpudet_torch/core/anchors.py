"""Anchor grids, numpy: the port's own copy of ``tpudet/core/anchors.py``'s
``AnchorGenerator`` (``:34-153``, RetinaNet's) and ``YOLOV4AnchorGenerator``
(grid anchors and base anchor sizes).

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

    def _single_level_base_anchors(self, base_size, center=None
                                   ) -> np.ndarray:
        w = h = float(base_size)
        if center is None:
            x_center = self.center_offset * w
            y_center = self.center_offset * h
        else:
            x_center, y_center = center
        h_ratios = np.sqrt(self.ratios)
        w_ratios = 1.0 / h_ratios
        if self.scale_major:
            ws = (w * w_ratios[:, None] * self.scales[None, :]).reshape(-1)
            hs = (h * h_ratios[:, None] * self.scales[None, :]).reshape(-1)
        else:
            ws = (w * self.scales[:, None] * w_ratios[None, :]).reshape(-1)
            hs = (h * self.scales[:, None] * h_ratios[None, :]).reshape(-1)
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


class YOLOV4AnchorGenerator:
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
