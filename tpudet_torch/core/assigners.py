"""The dense assigners: port of ``tpudet/core/assigners.py``'s MaxIoU
assigner of the generic anchor path (``:28-74``, ``max_iou_assign``,
``max_iou_assign_batch``), YOLOv3's grid assigner and the ATSS assigner.

Every anchor gets an int code over padded gts: ``IGNORE`` (-2),
``NEGATIVE`` (-1) or the index of its matched gt:

- positive to its argmax gt (the first on a tie) when the max IoU is at
  least ``pos_iou_thr``;
- negative below ``neg_iou_thr``, ignored in between;
- the low-quality claim: each valid gt with a max IoU of at least
  ``min_pos_iou`` (and above 0) claims its best anchors, every anchor that
  ties its max with ``gt_max_assign_all``, else the first; where several
  gts claim one anchor the highest gt index wins, as the reference's
  sequential loop leaves it;
- an image without a valid gt is negative everywhere.

Ties are found with ``ious == gt_max``, so the codes are as exact as the
IoUs: torch's IoU takes the same rounded steps as tpudet's on the CPU.

``grid_assign_batch`` is YOLOv3's GridAssigner (``:77-120``) in the same
codes.

``atss_assign_batch`` is the ATSS assigner (``:123-185``), dense over
(anchors, gts), in the same codes without ``IGNORE``:

- per gt and level the ``topk`` anchors closest by centre distance are
  candidates; ties go to the lower anchor index, as ``lax.top_k`` keeps
  them (a stable sort: ``torch.topk`` promises no order);
- the gt's threshold is the mean plus the population std of its
  candidates' IoUs (``nanmean`` over the candidates);
- a candidate at or above it whose centre lies strictly inside the gt is
  positive; an anchor positive for several gts takes the one of highest
  IoU, the first on a tie.

``priority_rank`` ranks entries by a fixed priority, the sampling of the
two-stage heads (``tpudet/models/dense_heads/rpn_head.py:104-117``).
"""
from __future__ import annotations

from typing import Sequence

import torch

from .bbox import bbox_overlaps

IGNORE = -2
NEGATIVE = -1


def max_iou_assign_batch(anchors: torch.Tensor,
                         gt_bboxes: torch.Tensor,
                         gt_valid: torch.Tensor,
                         pos_iou_thr: float = 0.5,
                         neg_iou_thr: float = 0.4,
                         min_pos_iou: float = 0.0,
                         match_low_quality: bool = True,
                         gt_max_assign_all: bool = True) -> torch.Tensor:
    """anchors (A, 4) shared by the batch or (B, A, 4) per image,
    gt_bboxes (B, G, 4) padded, gt_valid (B, G) -> (B, A) int64 codes."""
    b, g = gt_valid.shape
    if anchors.dim() == 2:
        anchors = anchors[None]
    ious = bbox_overlaps(anchors, gt_bboxes)  # (B, A, G)
    ious = torch.where(gt_valid[:, None, :], ious, ious.new_tensor(-1.0))
    max_iou = ious.amax(dim=2)
    argmax_gt = ious.argmax(dim=2)  # the first maximum on a tie
    assigned = torch.full_like(argmax_gt, IGNORE)
    assigned = torch.where(max_iou < neg_iou_thr, NEGATIVE, assigned)
    assigned = torch.where(max_iou >= pos_iou_thr, argmax_gt, assigned)
    if match_low_quality:
        gt_max = ious.amax(dim=1)  # (B, G)
        if gt_max_assign_all:
            is_tie = ious == gt_max[:, None, :]
        else:
            first = ious.argmax(dim=1)  # (B, G), the first maximal anchor
            rows = torch.arange(anchors.shape[1], device=anchors.device)
            is_tie = rows[None, :, None] == first[:, None, :]
        gt_ok = gt_valid & (gt_max >= min_pos_iou) & (gt_max > 0)
        is_best = is_tie & gt_ok[:, None, :]
        g_idx = torch.arange(g, dtype=torch.int32, device=anchors.device)
        claim = torch.where(is_best, g_idx, torch.full_like(g_idx, -1)
                            ).amax(dim=2).long()  # the highest gt index
        assigned = torch.where(claim >= 0, claim, assigned)
    return torch.where(gt_valid.any(dim=1, keepdim=True), assigned,
                       NEGATIVE)


def max_iou_assign(anchors: torch.Tensor,
                   gt_bboxes: torch.Tensor,
                   gt_valid: torch.Tensor,
                   pos_iou_thr: float = 0.5,
                   neg_iou_thr: float = 0.4,
                   min_pos_iou: float = 0.0,
                   match_low_quality: bool = True,
                   gt_max_assign_all: bool = True) -> torch.Tensor:
    """One image: anchors (A, 4), gt_bboxes (G, 4), gt_valid (G,) -> (A,)
    codes."""
    return max_iou_assign_batch(anchors, gt_bboxes[None], gt_valid[None],
                                pos_iou_thr, neg_iou_thr, min_pos_iou,
                                match_low_quality, gt_max_assign_all)[0]


def grid_assign_batch(anchors: torch.Tensor,
                      responsible: torch.Tensor,
                      gt_bboxes: torch.Tensor,
                      gt_valid: torch.Tensor,
                      pos_iou_thr: float = 0.5,
                      neg_iou_thr: float = 0.5,
                      min_pos_iou: float = 0.0) -> torch.Tensor:
    """anchors (A, 4), responsible (B, A) bool, gt_bboxes (B, G, 4),
    gt_valid (B, G) -> (B, A) int64 codes:

    1. ignore by default;
    2. negative where the max IoU over the valid gts is in [0,
       ``neg_iou_thr``];
    3. a responsible anchor whose max IoU over the gts is above
       ``pos_iou_thr`` takes that (first) argmax gt;
    4. each valid gt claims its best responsible anchors (every tie) whose
       IoU is above ``min_pos_iou``; the highest gt index wins;
    5. an image without a valid gt is negative everywhere."""
    g = gt_valid.shape[1]
    ious = bbox_overlaps(anchors[None], gt_bboxes)  # (B, A, G)
    ious = torch.where(gt_valid[:, None, :], ious, ious.new_tensor(-1.0))
    max_all = ious.amax(dim=2)
    assigned = torch.full(max_all.shape, IGNORE, dtype=torch.int64,
                          device=anchors.device)
    assigned = torch.where((max_all >= 0) & (max_all <= neg_iou_thr),
                           NEGATIVE, assigned)
    resp_ious = torch.where(responsible[..., None], ious,
                            ious.new_tensor(-1.0))
    max_resp = resp_ious.amax(dim=2)
    pos = (max_resp > pos_iou_thr) & responsible
    assigned = torch.where(pos, resp_ious.argmax(dim=2), assigned)
    gt_max = resp_ious.amax(dim=1)  # (B, G)
    is_best = (resp_ious == gt_max[:, None, :]) & (
        gt_valid & (gt_max > min_pos_iou))[:, None, :]
    g_idx = torch.arange(g, dtype=torch.int32, device=anchors.device)
    claim = torch.where(is_best, g_idx, torch.full_like(g_idx, -1)
                        ).amax(dim=2).long()
    assigned = torch.where(claim >= 0, claim, assigned)
    return torch.where(gt_valid.any(dim=1, keepdim=True), assigned,
                       NEGATIVE)


def atss_assign_batch(anchors: torch.Tensor,
                      num_level_anchors: Sequence[int],
                      gt_bboxes: torch.Tensor,
                      gt_valid: torch.Tensor,
                      topk: int = 9) -> torch.Tensor:
    """anchors (A, 4) shared by the batch, ``num_level_anchors`` the
    per-level counts (levels contiguous in ``anchors``), gt_bboxes (B, G,
    4) padded, gt_valid (B, G) -> (B, A) int64: ``NEGATIVE`` or the
    matched gt's index."""
    num_anchors = anchors.shape[0]
    ious = bbox_overlaps(anchors[None], gt_bboxes)  # (B, A, G)
    ious = torch.where(gt_valid[:, None, :], ious, ious.new_tensor(-1.0))
    a_cx = (anchors[:, 0] + anchors[:, 2]) * 0.5
    a_cy = (anchors[:, 1] + anchors[:, 3]) * 0.5
    g_cx = (gt_bboxes[..., 0] + gt_bboxes[..., 2]) * 0.5
    g_cy = (gt_bboxes[..., 1] + gt_bboxes[..., 3]) * 0.5
    # (B, G, A): each gt's distances along the last axis, where the sort is
    dist = torch.sqrt((a_cx - g_cx[..., None]).square() +
                      (a_cy - g_cy[..., None]).square())
    candidate = torch.zeros(dist.shape, dtype=torch.bool,
                            device=anchors.device)
    start = 0
    for n in num_level_anchors:
        k = min(topk, n)
        idx = torch.sort(dist[..., start:start + n], dim=-1,
                         stable=True).indices[..., :k]
        candidate[..., start:start + n].scatter_(-1, idx, True)
        start += n
    assert start == num_anchors, (start, num_anchors)
    candidate = candidate.transpose(1, 2)  # (B, A, G)

    cand_ious = torch.where(candidate, ious, ious.new_tensor(float('nan')))
    mean = torch.nanmean(cand_ious, dim=1)  # (B, G)
    std = torch.sqrt(torch.nanmean((cand_ious - mean[:, None]).square(),
                                   dim=1))
    thr = mean + std
    inside = ((a_cx[:, None] > gt_bboxes[:, None, :, 0]) &
              (a_cx[:, None] < gt_bboxes[:, None, :, 2]) &
              (a_cy[:, None] > gt_bboxes[:, None, :, 1]) &
              (a_cy[:, None] < gt_bboxes[:, None, :, 3]))
    pos = candidate & (ious >= thr[:, None]) & inside & gt_valid[:, None]
    pos_ious = torch.where(pos, ious, ious.new_tensor(-1.0))
    best_gt = pos_ious.argmax(dim=2)  # the first maximum on a tie
    return torch.where(pos.any(dim=2), best_gt, NEGATIVE)


def atss_assign(anchors: torch.Tensor, num_level_anchors: Sequence[int],
                gt_bboxes: torch.Tensor, gt_valid: torch.Tensor,
                topk: int = 9) -> torch.Tensor:
    """One image: gt_bboxes (G, 4), gt_valid (G,) -> (A,) codes."""
    return atss_assign_batch(anchors, num_level_anchors, gt_bboxes[None],
                             gt_valid[None], topk)[0]


def priority_rank(mask: torch.Tensor, priority: torch.Tensor) -> torch.Tensor:
    """Each entry's rank (B, N) in the stable ascending order of ``priority``
    (N,) over the ``mask``-ed entries, every other entry after them at 2.0:
    tpudet's ``argsort(argsort(where(mask, priority, 2.0)))`` of its
    fixed-priority sampling (ties by index), the second sort an inverse
    permutation."""
    keyed = torch.where(mask, priority[None],
                        torch.full_like(priority, 2.0)[None])
    order = torch.argsort(keyed, dim=1, stable=True)
    rank = torch.empty_like(order)
    rank.scatter_(1, order, torch.arange(order.shape[1],
                                         device=order.device).expand_as(order))
    return rank
