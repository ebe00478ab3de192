"""YOLO anchor grids, numpy: the port's own copy of
``tpudet/core/anchors.py::YOLOAnchorGenerator`` / ``YOLOV4AnchorGenerator``
(grid anchors and base anchor sizes).

Base anchors are xyxy around a per-level centre at stride/2; grid anchors
shift them by (x*stride_w, y*stride_h), row-major with the base-anchor axis
fastest, so NHWC pred maps reshape directly onto the anchor axis.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def _pair(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x, x)


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
        out = []
        for base, (feat_h, feat_w), stride in zip(
                self.base_anchors, featmap_sizes, self.strides):
            shift_x = np.arange(0, feat_w, dtype=np.float32) * stride[0]
            shift_y = np.arange(0, feat_h, dtype=np.float32) * stride[1]
            xx = np.tile(shift_x, feat_h)
            yy = np.repeat(shift_y, feat_w)
            shifts = np.stack([xx, yy, xx, yy], axis=-1)
            anchors = base[None, :, :] + shifts[:, None, :]
            out.append(anchors.reshape(-1, 4).astype(np.float32))
        return out
