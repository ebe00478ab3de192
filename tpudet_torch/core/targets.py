"""Dense, shape-static YOLOv4/v5 target assignment: port of
``tpudet/core/targets.py``.

Every (gt, base anchor, neighbour offset) slot of a padded gt tensor gets
a flat anchor index and a match flag, so the loss runs over fixed shapes
with masks. The slot layout (B, G, A, O), the offset order and the flat
index (row-major cells, base-anchor axis fastest) are tpudet's: the loss
means and the conf-target scatter depend on them.
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

# offset order of the reference's yolov4_anchor_generator.py:55-63
_NEIGHBOR_OFFSETS = np.array(
    [[0, 0], [-1, 0], [0, -1], [1, 0], [0, 1],
     [-1, -1], [1, -1], [1, 1], [-1, 1]], dtype=np.float32)


class LevelMatches(NamedTuple):
    """Per-level padded matches. Leading dims: (B, G, A, O)."""
    anchor_idx: torch.Tensor  # int64 flat index into H*W*A anchors
    mask: torch.Tensor  # bool: the slot is a real match


def responsible_matches(gt_bboxes: torch.Tensor,
                        gt_valid: torch.Tensor,
                        featmap_size: Tuple[int, int],
                        stride: float,
                        base_anchor_wh: np.ndarray,
                        neighbor: int = 2,
                        shape_match_thres: float = 4.0) -> LevelMatches:
    """Single-level matches (``tpudet/core/targets.py:36-110``).

    Args:
        gt_bboxes: (B, G, 4) xyxy, zero-padded.
        gt_valid: (B, G) bool mask of real gts.
        featmap_size: (H, W).
        stride: level stride.
        base_anchor_wh: (A, 2) widths/heights of the level's base anchors.
        neighbor: 0 (centre cell), 2 (the 2 nearest neighbours, the
            assigner-free default) or 3 (all 8).
        shape_match_thres: bound on the wh ratio's deviation.

    Returns:
        LevelMatches with (B, G, A, O) tensors, O = 1/5/9 offsets.
    """
    feat_h, feat_w = featmap_size
    dev = gt_bboxes.device
    num_anchors = base_anchor_wh.shape[0]

    gt_xy = (gt_bboxes[..., 2:4] + gt_bboxes[..., 0:2]) * 0.5  # (B, G, 2)
    gt_wh = gt_bboxes[..., 2:4] - gt_bboxes[..., 0:2]

    # shape match: max(ratio, 1/ratio) over w and h below the threshold;
    # eps guards padded zero-size gts (masked anyway)
    anchor_wh = torch.as_tensor(base_anchor_wh, dtype=torch.float32,
                                device=dev)  # (A, 2)
    ratio = gt_wh[..., None, :] / anchor_wh  # (B, G, A, 2)
    deviation = torch.maximum(ratio, 1.0 / torch.clamp_min(ratio, 1e-9))
    deviation = deviation.amax(dim=-1)  # (B, G, A)
    shape_match = (deviation < shape_match_thres) & gt_valid[..., None]

    xy_grid = gt_xy / stride  # (B, G, 2)
    xy_grid_inv = torch.tensor([feat_w, feat_h], dtype=torch.float32,
                               device=dev) - xy_grid

    # neighbour-cell validity; % is Python's remainder, as jnp's
    x_left_ok = (xy_grid[..., 0] % 1.0 < 0.5) & (xy_grid[..., 0] > 1.0)
    y_up_ok = (xy_grid[..., 1] % 1.0 < 0.5) & (xy_grid[..., 1] > 1.0)
    x_right_ok = (xy_grid_inv[..., 0] % 1.0 < 0.5) & (xy_grid_inv[..., 0] >
                                                       1.0)
    y_down_ok = (xy_grid_inv[..., 1] % 1.0 < 0.5) & (xy_grid_inv[..., 1] >
                                                      1.0)
    ones = torch.ones_like(x_left_ok)

    if neighbor == 0:
        neighbor_ok = ones[..., None]  # (B, G, 1)
    elif neighbor == 2:
        neighbor_ok = torch.stack(
            [ones, x_left_ok, y_up_ok, x_right_ok, y_down_ok], dim=-1)
    elif neighbor == 3:
        neighbor_ok = torch.stack([
            ones, x_left_ok, y_up_ok, x_right_ok, y_down_ok,
            x_left_ok & y_up_ok, x_right_ok & y_up_ok,
            x_right_ok & y_down_ok, x_left_ok & y_down_ok], dim=-1)
    else:
        raise NotImplementedError(f'neighbor={neighbor}')
    num_offsets = neighbor_ok.shape[-1]
    offsets = torch.as_tensor(_NEIGHBOR_OFFSETS[:num_offsets], device=dev)

    # cell of each offset; valid coordinates are >= 0, so floor == trunc
    cell_xy = torch.floor(xy_grid[..., None, :] + offsets)  # (B, G, O, 2)
    cell_x = torch.clamp(cell_xy[..., 0].to(torch.int32), 0, feat_w - 1)
    cell_y = torch.clamp(cell_xy[..., 1].to(torch.int32), 0, feat_h - 1)
    cell_flat = cell_y.long() * feat_w + cell_x.long()  # (B, G, O)

    anchor_idx = (cell_flat[..., None, :] * num_anchors +
                  torch.arange(num_anchors, device=dev)[:, None])
    mask = shape_match[..., None] & neighbor_ok[..., None, :]  # (B,G,A,O)
    return LevelMatches(anchor_idx, mask)


def multilevel_responsible_matches(gt_bboxes, gt_valid,
                                   featmap_sizes: Sequence[Tuple[int, int]],
                                   strides: Sequence[float],
                                   base_anchor_whs: Sequence[np.ndarray],
                                   neighbor: int = 2,
                                   shape_match_thres: float = 4.0
                                   ) -> List[LevelMatches]:
    """All levels."""
    return [
        responsible_matches(gt_bboxes, gt_valid, featmap_sizes[i],
                            strides[i], base_anchor_whs[i], neighbor,
                            shape_match_thres)
        for i in range(len(featmap_sizes))
    ]
