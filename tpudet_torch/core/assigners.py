"""The dense MaxIoU assigner of the generic anchor path: port of
``tpudet/core/assigners.py:28-74`` (``max_iou_assign``,
``max_iou_assign_batch``).

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

``priority_rank`` ranks entries by a fixed priority, the sampling of the
two-stage heads (``tpudet/models/dense_heads/rpn_head.py:104-117``).
"""
from __future__ import annotations

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
