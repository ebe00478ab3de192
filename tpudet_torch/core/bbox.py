"""Box coders and IoU primitives: port of ``tpudet/core/bbox.py``
(``YOLOV4BBoxCoder``, ``YOLOBBoxCoder``, ``DeltaXYWHBBoxCoder``,
``TBLRBBoxCoder``, ``BucketingBBoxCoder``, ``bbox_overlaps``, ``bbox_overlaps_aligned``,
``bbox_cxcywh``). All boxes
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
    ``add_ctr_clamp`` variant (``:70-78``, the branch at ``:111``) clamps
    the centre's shift to ``ctr_clamp`` pixels and dw, dh from above
    only."""

    def __init__(self, target_means=(0., 0., 0., 0.),
                 target_stds=(1., 1., 1., 1.), clip_border=True,
                 add_ctr_clamp=False, ctr_clamp=32):
        self.means = np.asarray(target_means, dtype=np.float32)
        self.stds = np.asarray(target_stds, dtype=np.float32)
        self.clip_border = clip_border
        self.add_ctr_clamp = add_ctr_clamp
        self.ctr_clamp = ctr_clamp

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
        if self.add_ctr_clamp:
            dx_width = torch.clamp(dx_width, -self.ctr_clamp, self.ctr_clamp)
            dy_height = torch.clamp(dy_height, -self.ctr_clamp,
                                    self.ctr_clamp)
            dw = torch.clamp_max(deltas[..., 2], max_ratio)
            dh = torch.clamp_max(deltas[..., 3], max_ratio)
        else:
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


class TBLRBBoxCoder:
    """FSAF's top-bottom-left-right coder (``tpudet/core/bbox.py:182-222``):
    the distances from the anchor's centre to the gt's sides over the
    anchor's height (t, b) or width (l, r), divided by ``normalizer``.
    ``encode`` clamps the anchor's sides at 1e-6, as tpudet's; ``decode``
    with ``clip_border`` clips to ``max_shape`` ``(h, w)`` (numbers or
    per-image (B, 1) columns)."""

    def __init__(self, normalizer: float = 4.0, clip_border: bool = True):
        self.normalizer = normalizer
        self.clip_border = clip_border

    def encode(self, bboxes, gt_bboxes):
        cx = (bboxes[..., 0] + bboxes[..., 2]) * 0.5
        cy = (bboxes[..., 1] + bboxes[..., 3]) * 0.5
        w = torch.clamp_min(bboxes[..., 2] - bboxes[..., 0], 1e-6)
        h = torch.clamp_min(bboxes[..., 3] - bboxes[..., 1], 1e-6)
        out = torch.stack([(cy - gt_bboxes[..., 1]) / h,
                           (gt_bboxes[..., 3] - cy) / h,
                           (cx - gt_bboxes[..., 0]) / w,
                           (gt_bboxes[..., 2] - cx) / w], dim=-1)
        return out / self.normalizer

    def decode(self, bboxes, pred_bboxes, max_shape=None):
        cx = (bboxes[..., 0] + bboxes[..., 2]) * 0.5
        cy = (bboxes[..., 1] + bboxes[..., 3]) * 0.5
        w = bboxes[..., 2] - bboxes[..., 0]
        h = bboxes[..., 3] - bboxes[..., 1]
        tblr = pred_bboxes * self.normalizer
        x1, y1 = cx - tblr[..., 2] * w, cy - tblr[..., 0] * h
        x2, y2 = cx + tblr[..., 3] * w, cy + tblr[..., 1] * h
        if self.clip_border and max_shape is not None:
            x1 = _clip_to(x1, max_shape[1])
            y1 = _clip_to(y1, max_shape[0])
            x2 = _clip_to(x2, max_shape[1])
            y2 = _clip_to(y2, max_shape[0])
        return torch.stack([x1, y1, x2, y2], dim=-1)


def _stable_order(x):
    """Indices sorting ``x`` ascending along the last axis, ties by index
    (``jnp.argsort``'s order; ``torch.argsort`` promises none unless
    stable)."""
    return torch.sort(x, dim=-1, stable=True)[1]


class BucketingBBoxCoder:
    """SABL's side-aware bucketing coder (``tpudet/core/bbox.py:272-373``):
    each side of a box is placed among ``side_num = ceil(num_buckets / 2)``
    buckets of its proposal rescaled by ``scale_factor``, then offset from
    that bucket's centre in bucket widths.

    ``encode`` gives, each (..., 4, side_num) in the order (left, right,
    top, bottom): the nearest bucket's one-hot, the class weights (0 at
    every other bucket within one bucket width of the side), the offsets,
    and the offset weights (1 at the nearest bucket, at the next
    ``offset_topk - 1`` where their own |offset| is under
    ``offset_upperbound``). The ranks come from a stable sort: a side
    midway between two centres gives the lower bucket, as tpudet's.

    ``decode`` takes ``(cls_preds, offset_preds)`` of (..., 4 side_num),
    a softmax over the buckets, the top two (ties by index), the best
    bucket's centre shifted by its offset, clipped to ``max_shape - 1``
    where given, and the rescoring confidence: the mean over the sides of
    the top probability, plus the runner-up's where the two buckets are
    adjacent. Returns ``(boxes, confidence)``."""

    def __init__(self, num_buckets: int = 14, scale_factor: float = 3.0,
                 offset_topk: int = 2, offset_upperbound: float = 1.0,
                 cls_ignore_neighbor: bool = True):
        self.num_buckets = num_buckets
        self.scale_factor = scale_factor
        self.offset_topk = offset_topk
        self.offset_upperbound = offset_upperbound
        self.cls_ignore_neighbor = cls_ignore_neighbor

    @property
    def side_num(self) -> int:
        return int(np.ceil(self.num_buckets / 2.0))

    def _sides(self, proposals):
        """The bucket centres of each side, (..., 4, S), and the bucket
        widths (..., 4)."""
        cx = (proposals[..., 0] + proposals[..., 2]) * 0.5
        cy = (proposals[..., 1] + proposals[..., 3]) * 0.5
        w = (proposals[..., 2] - proposals[..., 0]) * self.scale_factor
        h = (proposals[..., 3] - proposals[..., 1]) * self.scale_factor
        bw = w / self.num_buckets
        bh = h / self.num_buckets
        steps = 0.5 + torch.arange(self.side_num, dtype=torch.float32,
                                   device=proposals.device)
        steps = steps.to(torch.promote_types(steps.dtype, bw.dtype))
        px1, px2 = cx - w / 2, cx + w / 2
        py1, py2 = cy - h / 2, cy + h / 2
        sides = torch.stack([px1[..., None] + steps * bw[..., None],
                             px2[..., None] - steps * bw[..., None],
                             py1[..., None] + steps * bh[..., None],
                             py2[..., None] - steps * bh[..., None]], dim=-2)
        return sides, torch.stack([bw, bw, bh, bh], dim=-1)

    def encode(self, proposals, gts):
        sides, scale = self._sides(proposals)
        g = torch.stack([gts[..., 0], gts[..., 2], gts[..., 1], gts[..., 3]],
                        dim=-1)
        offsets = (sides - g[..., None]) / torch.clamp_min(scale[..., None],
                                                           1e-6)
        absoff = offsets.abs()
        order = _stable_order(absoff)
        rank = _stable_order(order)
        labels = (rank == 0).to(offsets.dtype)
        if self.offset_upperbound is not None:
            within = (absoff < self.offset_upperbound).to(offsets.dtype)
        else:
            within = torch.ones_like(absoff)
        one, zero = offsets.new_ones(()), offsets.new_zeros(())
        off_w = torch.where(rank == 0, one, torch.where(
            rank < self.offset_topk, within, zero))
        if self.cls_ignore_neighbor:
            cls_w = 1.0 - ((absoff < 1.0) & (labels == 0)).to(offsets.dtype)
        else:
            cls_w = torch.ones_like(labels)
        return labels, cls_w, offsets, off_w

    def decode(self, proposals, pred_bboxes, max_shape=None):
        cls_preds, offset_preds = pred_bboxes
        s = self.side_num
        shape = cls_preds.shape[:-1] + (4, s)
        scores = torch.softmax(cls_preds.reshape(shape), dim=-1)
        offs = offset_preds.reshape(shape)
        top2, idx2 = torch.sort(scores, dim=-1, descending=True, stable=True)
        top2, idx2 = top2[..., :2], idx2[..., :2]
        best = idx2[..., :1]
        sides, scale = self._sides(proposals)
        pick_side = torch.gather(sides.expand(shape), -1, best)[..., 0]
        pick_off = torch.gather(offs, -1, best)[..., 0]
        edge = pick_side - pick_off * scale  # (..., 4): x1, x2, y1, y2
        x1, x2, y1, y2 = edge.unbind(-1)
        if max_shape is not None:
            x1 = _clip_to(x1, max_shape[1] - 1)
            x2 = _clip_to(x2, max_shape[1] - 1)
            y1 = _clip_to(y1, max_shape[0] - 1)
            y2 = _clip_to(y2, max_shape[0] - 1)
        boxes = torch.stack([x1, y1, x2, y2], dim=-1)
        adjacent = (idx2[..., 0] - idx2[..., 1]).abs() == 1
        side_conf = top2[..., 0] + torch.where(adjacent, top2[..., 1],
                                               top2.new_zeros(()))
        return boxes, side_conf.mean(dim=-1)


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
