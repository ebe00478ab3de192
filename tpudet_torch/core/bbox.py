"""Box coders and IoU primitives: port of ``tpudet/core/bbox.py``
(``YOLOV4BBoxCoder``, ``YOLOBBoxCoder``, ``DeltaXYWHBBoxCoder``,
``bbox_overlaps``, ``bbox_overlaps_aligned``, ``bbox_cxcywh``). All boxes
are xyxy; the functions broadcast over leading axes."""
from __future__ import annotations

import numpy as np
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


class YOLOBBoxCoder:
    """YOLOv3's coder (``tpudet/core/bbox.py:136-183``): xy as the in-cell
    offset, clipped to [eps, 1 - eps] (the target of a sigmoid), wh as the
    log of the scale against the anchor, clipped below at ``log(eps)``."""

    def __init__(self, eps: float = 1e-6):
        self.eps = eps

    def encode(self, bboxes, gt_bboxes, stride):
        x_c = (bboxes[..., 0] + bboxes[..., 2]) * 0.5
        y_c = (bboxes[..., 1] + bboxes[..., 3]) * 0.5
        w = bboxes[..., 2] - bboxes[..., 0]
        h = bboxes[..., 3] - bboxes[..., 1]
        gx = (gt_bboxes[..., 0] + gt_bboxes[..., 2]) * 0.5
        gy = (gt_bboxes[..., 1] + gt_bboxes[..., 3]) * 0.5
        gw = gt_bboxes[..., 2] - gt_bboxes[..., 0]
        gh = gt_bboxes[..., 3] - gt_bboxes[..., 1]
        w_t = torch.log(torch.clamp_min(gw / w, self.eps))
        h_t = torch.log(torch.clamp_min(gh / h, self.eps))
        x_t = torch.clamp((gx - x_c) / stride + 0.5, self.eps, 1 - self.eps)
        y_t = torch.clamp((gy - y_c) / stride + 0.5, self.eps, 1 - self.eps)
        return torch.stack([x_t, y_t, w_t, h_t], dim=-1)

    @staticmethod
    def decode(bboxes, pred_bboxes, stride):
        """``pred_bboxes``: xy already through the sigmoid, wh the raw log
        scales, clamped at 8 before ``exp`` as tpudet's (an inf corner
        would make NaN IoUs in the NMS; only untrained or diverged
        predictions reach the clamp)."""
        x_c = (bboxes[..., 0] + bboxes[..., 2]) * 0.5
        y_c = (bboxes[..., 1] + bboxes[..., 3]) * 0.5
        w = bboxes[..., 2] - bboxes[..., 0]
        h = bboxes[..., 3] - bboxes[..., 1]
        xp = (pred_bboxes[..., 0] - 0.5) * stride + x_c
        yp = (pred_bboxes[..., 1] - 0.5) * stride + y_c
        wp = torch.exp(torch.clamp_max(pred_bboxes[..., 2], 8.0)) * w
        hp = torch.exp(torch.clamp_max(pred_bboxes[..., 3], 8.0)) * h
        return torch.stack((xp - wp / 2, yp - hp / 2, xp + wp / 2,
                            yp + hp / 2), dim=-1)


def _clip_to(x, hi):
    """``jnp.clip(x, 0, hi)`` where ``hi`` is a number or a tensor that
    broadcasts against ``x`` (per-image (B, 1) columns)."""
    return torch.minimum(torch.clamp_min(x, 0),
                         torch.as_tensor(hi, dtype=x.dtype, device=x.device))


class DeltaXYWHBBoxCoder:
    """The delta xywh coder of the generic anchor path (RetinaNet,
    ``tpudet/core/bbox.py:57-132``): normalized (dx, dy, dw, dh) with
    means and stds; decode clamps dw and dh at ``log(wh_ratio_clip)`` and,
    with ``clip_border``, clips to ``max_shape``. YOLOF's
    ``add_ctr_clamp`` variant comes with YOLOF."""

    def __init__(self, target_means=(0., 0., 0., 0.),
                 target_stds=(1., 1., 1., 1.), clip_border=True,
                 add_ctr_clamp=False, ctr_clamp=32):
        if add_ctr_clamp:
            raise NotImplementedError(
                'DeltaXYWHBBoxCoder(add_ctr_clamp=True) is YOLOF\'s; it '
                'comes with ROADMAP.md\'s "rest of the zoo" item')
        self.means = np.asarray(target_means, dtype=np.float32)
        self.stds = np.asarray(target_stds, dtype=np.float32)
        self.clip_border = clip_border

    def _stats(self, like):
        return (torch.as_tensor(self.means, device=like.device),
                torch.as_tensor(self.stds, device=like.device))

    def encode(self, bboxes, gt_bboxes):
        """Deltas of ``gt_bboxes`` from ``bboxes``. Widths and heights are
        clamped at 1e-6, as tpudet's: a padded or degenerate row gives a
        finite delta, not ``log(0)``."""
        px = (bboxes[..., 0] + bboxes[..., 2]) * 0.5
        py = (bboxes[..., 1] + bboxes[..., 3]) * 0.5
        pw = torch.clamp_min(bboxes[..., 2] - bboxes[..., 0], 1e-6)
        ph = torch.clamp_min(bboxes[..., 3] - bboxes[..., 1], 1e-6)
        gx = (gt_bboxes[..., 0] + gt_bboxes[..., 2]) * 0.5
        gy = (gt_bboxes[..., 1] + gt_bboxes[..., 3]) * 0.5
        gw = torch.clamp_min(gt_bboxes[..., 2] - gt_bboxes[..., 0], 1e-6)
        gh = torch.clamp_min(gt_bboxes[..., 3] - gt_bboxes[..., 1], 1e-6)
        deltas = torch.stack([(gx - px) / pw, (gy - py) / ph,
                              torch.log(gw / pw), torch.log(gh / ph)], dim=-1)
        means, stds = self._stats(deltas)
        return (deltas - means) / stds

    def decode(self, bboxes, pred_bboxes, max_shape=None,
               wh_ratio_clip=16 / 1000):
        """Boxes from ``bboxes`` and deltas. ``max_shape`` is ``(h, w)``:
        numbers, or per-image (B, 1) columns as ``single_device_test``
        passes them."""
        means, stds = self._stats(pred_bboxes)
        deltas = pred_bboxes * stds + means
        max_ratio = abs(float(np.log(wh_ratio_clip)))
        px = (bboxes[..., 0] + bboxes[..., 2]) * 0.5
        py = (bboxes[..., 1] + bboxes[..., 3]) * 0.5
        pw = bboxes[..., 2] - bboxes[..., 0]
        ph = bboxes[..., 3] - bboxes[..., 1]
        dx_width = pw * deltas[..., 0]
        dy_height = ph * deltas[..., 1]
        dw = torch.clamp(deltas[..., 2], -max_ratio, max_ratio)
        dh = torch.clamp(deltas[..., 3], -max_ratio, max_ratio)
        gw = pw * torch.exp(dw)
        gh = ph * torch.exp(dh)
        gx = px + dx_width
        gy = py + dy_height
        x1 = gx - gw * 0.5
        y1 = gy - gh * 0.5
        x2 = gx + gw * 0.5
        y2 = gy + gh * 0.5
        if self.clip_border and max_shape is not None:
            x1 = _clip_to(x1, max_shape[1])
            y1 = _clip_to(y1, max_shape[0])
            x2 = _clip_to(x2, max_shape[1])
            y2 = _clip_to(y2, max_shape[0])
        return torch.stack([x1, y1, x2, y2], dim=-1)


def _area(boxes):
    return ((boxes[..., 2] - boxes[..., 0]) *
            (boxes[..., 3] - boxes[..., 1]))


def bbox_overlaps_aligned(bboxes1, bboxes2, mode: str = 'iou',
                          eps: float = 1e-6):
    """Element-wise IoU, IoF or GIoU between same-shape (..., 4) xyxy
    boxes (``tpudet/core/bbox.py:229-253``). ``torch.maximum``/``minimum``
    split the gradient at a tie, as ``jnp.maximum``/``jnp.clip`` do."""
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
    if mode == 'iof':
        return overlap / torch.maximum(_area(bboxes1), union.new_tensor(eps))
    if mode == 'giou':
        enclose_lt = torch.minimum(bboxes1[..., :2], bboxes2[..., :2])
        enclose_rb = torch.maximum(bboxes1[..., 2:], bboxes2[..., 2:])
        enclose_wh = torch.maximum(enclose_rb - enclose_lt, zero)
        enclose_area = torch.maximum(enclose_wh[..., 0] * enclose_wh[..., 1],
                                     union.new_tensor(eps))
        return ious - (enclose_area - union) / enclose_area
    raise ValueError(f'unknown mode {mode}')


def bbox_overlaps(bboxes1, bboxes2, mode: str = 'iou', eps: float = 1e-6):
    """Pairwise IoU/IoF/GIoU: (..., N, 4) x (..., M, 4) -> (..., N, M)."""
    return bbox_overlaps_aligned(bboxes1[..., :, None, :],
                                 bboxes2[..., None, :, :], mode=mode, eps=eps)


def bbox_cxcywh(bboxes):
    """xyxy -> (cx, cy, w, h)."""
    cx = (bboxes[..., 0] + bboxes[..., 2]) * 0.5
    cy = (bboxes[..., 1] + bboxes[..., 3]) * 0.5
    w = bboxes[..., 2] - bboxes[..., 0]
    h = bboxes[..., 3] - bboxes[..., 1]
    return torch.stack([cx, cy, w, h], dim=-1)
