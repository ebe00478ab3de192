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
