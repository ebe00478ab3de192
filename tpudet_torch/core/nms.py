"""Class-aware NMS with lane budgets, batched over images: port of the
shipped path of ``tpudet/core/nms.py`` (``topk_scores``, ``nms_blocked``,
``lane_topk_select``, ``class_lane_nms``, ``batched_class_lane_nms``).

Semantics kept from tpudet, so that the detection sets are equal:

- score ties keep index order: every sort is ``torch.sort(stable=True)``
  (``torch.topk`` leaves the order of ties unspecified);
- suppression is strict ``iou > thr``, with tpudet's IoU arithmetic;
- ``lane_topk_select`` breaks ties at the first occurrence and pulls the
  box payload with an exact select-and-sum;
- outputs are fixed-size, ``max_out`` rows plus a ``valid`` mask.

The functions take a leading batch axis; one image is a batch of one.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e10


class NMSResult(NamedTuple):
    """Fixed-size detections, (B, max_per_img, ...)."""
    bboxes: torch.Tensor  # (B, max_per_img, 4)
    scores: torch.Tensor  # (B, max_per_img)
    labels: torch.Tensor  # (B, max_per_img) int64, -1 where not valid
    valid: torch.Tensor  # (B, max_per_img) bool


def topk_scores(scores: torch.Tensor, k: int):
    """(vals, idx) of the exact top-k along the last axis, ties broken by
    the lowest index (``lax.top_k``'s order). tpudet takes ``approx_max_k``
    above 16,384 candidates; on the CPU that returns exactly this."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _iou_block(bb, ba, other_boxes, other_area, eps=1e-6):
    """IoU of (..., B, 4) boxes against (..., M, 4) boxes -> (..., B, M)."""
    lt = torch.maximum(bb[..., :, None, :2], other_boxes[..., None, :, :2])
    rb = torch.minimum(bb[..., :, None, 2:], other_boxes[..., None, :, 2:])
    wh = torch.clamp_min(rb - lt, 0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / torch.clamp_min(
        ba[..., :, None] + other_area[..., None, :] - inter, eps)


def _in_block_greedy(bb, ba, alive0, tri, iou_threshold):
    """Greedy suppression inside a score-sorted block, as the Jacobi
    fixed point of ``keep = alive0 & ~any(suppressor kept)``; the fixed
    point is the greedy solution."""
    mat = (_iou_block(bb, ba, bb, ba) > iou_threshold) & tri
    keep = alive0
    while True:
        new = alive0 & ~torch.any(mat & keep[:, None, :], dim=-1)
        if torch.equal(new, keep):
            return keep
        keep = new


def nms_blocked(boxes: torch.Tensor,
                scores: torch.Tensor,
                iou_threshold: float,
                max_out: int,
                valid: Optional[torch.Tensor] = None,
                block: int = 512,
                return_dets: bool = False):
    """Greedy hard-NMS in score-sorted blocks of ``block`` candidates,
    exact. Per block: suppress by the boxes kept so far, resolve the
    block's own chains, append its keeps; stop once ``max_out`` keeps
    accumulated or only padding remains.

    Args:
        boxes: (B, K, 4); scores: (B, K); valid: optional (B, K) bool.

    Returns:
        ``(keep_idx, keep_valid)``, each (B, max_out), indices into K; with
        ``return_dets`` also the kept boxes and scores first. Slots past
        the last keep are 0 and not valid.
    """
    b, k = scores.shape
    dev = scores.device
    vmask = (torch.ones_like(scores, dtype=torch.bool) if valid is None
             else valid)
    masked = torch.where(vmask, scores, torch.full_like(scores, NEG_INF))
    svals, order = torch.sort(masked, dim=-1, descending=True, stable=True)
    sboxes = torch.gather(boxes, 1, order[..., None].expand(b, k, 4))
    svalid = svals > NEG_INF / 2

    nb = -(-k // block)
    pad = nb * block - k
    blocks_boxes = F.pad(sboxes, (0, 0, 0, pad)).reshape(b, nb, block, 4)
    blocks_valid = F.pad(svalid, (0, pad)).reshape(b, nb, block)
    blocks_idx = F.pad(order, (0, pad)).reshape(b, nb, block)
    blocks_scores = F.pad(svals, (0, pad)).reshape(b, nb, block)

    rank = torch.arange(block, device=dev)
    tri = rank[None, :] < rank[:, None]  # suppressor j ranks before i
    out_slots = torch.arange(max_out, device=dev)
    # one spare slot (index max_out) absorbs the writes that are dropped
    kept_boxes = boxes.new_zeros(b, max_out + 1, 4)
    kept_area = boxes.new_zeros(b, max_out + 1)
    kept_scores = scores.new_zeros(b, max_out + 1)
    kept_idx = torch.zeros(b, max_out + 1, dtype=torch.long, device=dev)
    count = torch.zeros(b, dtype=torch.long, device=dev)
    for bi in range(nb):
        # sorted order: a block led by padding holds only padding
        active = (count < max_out) & blocks_valid[:, bi, 0]
        if not bool(active.any()):
            break
        bb = blocks_boxes[:, bi]
        ba = (bb[..., 2] - bb[..., 0]) * (bb[..., 3] - bb[..., 1])
        kvalid = out_slots[None, :] < count[:, None]
        iou_kept = _iou_block(bb, ba, kept_boxes[:, :max_out],
                              kept_area[:, :max_out])
        suppressed = torch.any((iou_kept > iou_threshold) & kvalid[:, None, :],
                               dim=-1)
        alive0 = blocks_valid[:, bi] & active[:, None] & ~suppressed
        keep = _in_block_greedy(bb, ba, alive0, tri, iou_threshold)

        pos = count[:, None] + torch.cumsum(keep, dim=-1) - 1
        wpos = torch.where(keep & (pos < max_out), pos,
                           torch.full_like(pos, max_out))
        kept_boxes.scatter_(1, wpos[..., None].expand(b, block, 4), bb)
        kept_area.scatter_(1, wpos, ba)
        kept_scores.scatter_(1, wpos, blocks_scores[:, bi])
        kept_idx.scatter_(1, wpos, blocks_idx[:, bi])
        count = count + keep.sum(dim=-1)

    keep_valid = out_slots[None, :] < torch.clamp_max(count, max_out)[:, None]
    keep_idx = torch.where(keep_valid, kept_idx[:, :max_out], 0)
    if return_dets:
        boxes_out = torch.where(keep_valid[..., None],
                                kept_boxes[:, :max_out], 0.)
        scores_out = torch.where(keep_valid, kept_scores[:, :max_out], 0.)
        return boxes_out, scores_out, keep_idx, keep_valid
    return keep_idx, keep_valid


def lane_topk_select(bboxes: torch.Tensor,
                     scores: torch.Tensor,
                     score_thr: float,
                     k_per_lane: int = 2,
                     lanes: int = 128,
                     valid: Optional[torch.Tensor] = None):
    """Per-class candidate selection without a sort: the top
    ``k_per_lane`` scores of every ``lanes``-wide column of the candidate
    axis, ties at the first occurrence.

    Args:
        bboxes: (B, N, 4) boxes shared across classes.
        scores: (B, N, C) per-class scores, no background column.
        valid: optional (B, N) bool mask of real boxes.

    Returns:
        ``(svals (B, C, P), cand_boxes (B, C, P, 4))`` with
        ``P = lanes * k_per_lane``; empty slots have ``svals == NEG_INF``.
    """
    b, n, num_classes = scores.shape
    v = scores > score_thr
    if valid is not None:
        v = v & valid[..., None]
    st = torch.where(v, scores, torch.full_like(scores, NEG_INF))
    st = st.transpose(1, 2)  # (B, C, N)
    pad = (-n) % lanes
    if pad:
        st = F.pad(st, (0, pad), value=NEG_INF)
        bboxes = F.pad(bboxes, (0, 0, 0, pad))
    s = st.shape[-1] // lanes
    x = st.reshape(b, num_classes, s, lanes)
    bbs = bboxes.reshape(b, 1, s, lanes, 4)
    svals, cands = [], []
    for _ in range(k_per_lane):
        m = torch.amax(x, dim=2)  # (B, C, lanes)
        is_max = x == m[:, :, None, :]
        first = torch.cumsum(is_max, dim=2) == 1  # ties: lowest index
        pick = is_max & first  # one-hot over the sublane axis
        # exact payload pull: select, then sum one value with zeros
        cand = torch.where(pick[..., None], bbs, 0.).sum(dim=2)
        svals.append(m)
        cands.append(cand)
        x = torch.where(pick, torch.full_like(x, NEG_INF), x)
    return torch.cat(svals, dim=-1), torch.cat(cands, dim=2)


def batched_class_lane_nms(bboxes: torch.Tensor,
                           scores: torch.Tensor,
                           score_thr: float,
                           iou_thr: float,
                           max_per_img: int,
                           lane_pre: int = 4,
                           class_pre: int = 0,
                           valid: Optional[torch.Tensor] = None
                           ) -> NMSResult:
    """Class-aware NMS with lane-local budgets over a batch: the lane
    preselection, then (with ``class_pre``) an exact per-class top
    ``class_pre`` of it, then one blocked greedy walk over all classes at
    once, each class's boxes offset so that classes never overlap.

    Args:
        bboxes: (B, N, 4); scores: (B, N, C); valid: optional (B, N).
    """
    b, _, num_classes = scores.shape
    svals, cand_boxes = lane_topk_select(bboxes, scores, score_thr,
                                         k_per_lane=lane_pre, valid=valid)
    if 0 < class_pre < svals.shape[-1]:
        svals, order = torch.sort(svals, dim=-1, descending=True,
                                  stable=True)
        svals = svals[..., :class_pre]
        order = order[..., :class_pre]
        cand_boxes = torch.gather(
            cand_boxes, 2, order[..., None].expand(*order.shape, 4))
    p = svals.shape[-1]
    flat_scores = svals.reshape(b, num_classes * p)
    flat_boxes = cand_boxes.reshape(b, num_classes * p, 4)
    flat_valid = flat_scores > NEG_INF / 2
    labels = torch.arange(num_classes * p, device=scores.device) // p
    max_coord = torch.where(flat_valid[..., None], flat_boxes,
                            0.).amax(dim=(1, 2))
    step = (max_coord + 1.)[:, None]
    offs = labels.to(flat_boxes.dtype)[None, :] * step
    det_off_boxes, det_scores, keep_idx, keep_valid = nms_blocked(
        flat_boxes + offs[..., None], flat_scores, iou_thr, max_per_img,
        valid=flat_valid, return_dets=True)
    det_labels = torch.where(keep_valid, keep_idx // p, -1)
    det_boxes = det_off_boxes - torch.where(
        keep_valid, det_labels.to(det_off_boxes.dtype) * step, 0.)[..., None]
    return NMSResult(det_boxes, det_scores, det_labels, keep_valid)


def class_lane_nms(bboxes: torch.Tensor,
                   scores: torch.Tensor,
                   score_thr: float,
                   iou_thr: float,
                   max_per_img: int,
                   lane_pre: int = 4,
                   class_pre: int = 0,
                   valid: Optional[torch.Tensor] = None) -> NMSResult:
    """`batched_class_lane_nms` for one image: bboxes (N, 4), scores
    (N, C), valid (N,); returns (max_per_img, ...) rows."""
    res = batched_class_lane_nms(
        bboxes[None], scores[None], score_thr, iou_thr, max_per_img,
        lane_pre=lane_pre, class_pre=class_pre,
        valid=None if valid is None else valid[None])
    return NMSResult(*(t[0] for t in res))
