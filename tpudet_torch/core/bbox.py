"""YOLOv4/v5 box coder: port of ``tpudet/core/bbox.py::YOLOV4BBoxCoder``."""
from __future__ import annotations

import torch


class YOLOV4BBoxCoder:
    """Decode YOLOv4/v5 regressions around anchor centres:
    ``x = pred_x * stride + anchor_cx``, ``w = pred_w * anchor_w``. The
    sigmoid/affine transform of the raw logits happens in the head."""

    @staticmethod
    def decode(bboxes, pred_bboxes, stride):
        """bboxes: (..., 4) anchors xyxy; pred_bboxes: (..., 4) transformed
        predictions (xy in [-1, 1], wh multiplicative); stride: scalar or
        a tensor broadcasting against ``bboxes[..., 0]``."""
        x_center = (bboxes[..., 0] + bboxes[..., 2]) * 0.5
        y_center = (bboxes[..., 1] + bboxes[..., 3]) * 0.5
        w = bboxes[..., 2] - bboxes[..., 0]
        h = bboxes[..., 3] - bboxes[..., 1]
        x_pred = pred_bboxes[..., 0] * stride + x_center
        y_pred = pred_bboxes[..., 1] * stride + y_center
        w_pred = pred_bboxes[..., 2] * w
        h_pred = pred_bboxes[..., 3] * h
        return torch.stack((x_pred - w_pred / 2, y_pred - h_pred / 2,
                            x_pred + w_pred / 2, y_pred + h_pred / 2), dim=-1)


def _area(boxes):
    return ((boxes[..., 2] - boxes[..., 0]) *
            (boxes[..., 3] - boxes[..., 1]))


def bbox_overlaps_aligned(bboxes1, bboxes2, mode: str = 'iou',
                          eps: float = 1e-6):
    """Element-wise IoU or GIoU between same-shape (..., 4) xyxy boxes
    (``tpudet/core/bbox.py:229-253``). ``torch.maximum``/``minimum`` split
    the gradient at a tie, as ``jnp.maximum``/``jnp.clip`` do."""
    zero = bboxes1.new_zeros(())
    lt = torch.maximum(bboxes1[..., :2], bboxes2[..., :2])
    rb = torch.minimum(bboxes1[..., 2:], bboxes2[..., 2:])
    wh = torch.maximum(rb - lt, zero)
    overlap = wh[..., 0] * wh[..., 1]
    union = _area(bboxes1) + _area(bboxes2) - overlap
    union = torch.maximum(union, union.new_tensor(eps))
    ious = overlap / union
    if mode == 'iou':
        return ious
    if mode == 'giou':
        enclose_lt = torch.minimum(bboxes1[..., :2], bboxes2[..., :2])
        enclose_rb = torch.maximum(bboxes1[..., 2:], bboxes2[..., 2:])
        enclose_wh = torch.maximum(enclose_rb - enclose_lt, zero)
        enclose_area = torch.maximum(enclose_wh[..., 0] * enclose_wh[..., 1],
                                     union.new_tensor(eps))
        return ious - (enclose_area - union) / enclose_area
    raise ValueError(f'unknown mode {mode} (the port has iou and giou)')
