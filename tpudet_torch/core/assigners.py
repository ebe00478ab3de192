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

``uniform_assign_batch`` is YOLOF's uniform matching (``:188-247``) in
the same codes:

- per gt the ``match_times`` predicted boxes and the ``match_times``
  anchors of least L1 distance in (cx, cy, w, h) are candidates; ties go
  to the lower anchor index (a stable sort, as ``lax.top_k``'s order);
- candidates are written in tpudet's flat order (for each of the k
  ranks, the predictions' candidates of every gt, then the anchors'), the
  last write to an anchor wins: a scatter-max of the order, as tpudet's;
- a winner whose anchor IoU with its gt is below ``pos_ignore_thr`` is
  ignored; any other anchor whose prediction overlaps a gt by more than
  ``neg_ignore_thr`` is ignored, else negative.

``uniform_match_pairs_batch`` (``:250-290``) lists every candidate pair,
duplicates included, with ``pair_pos``: the pair's anchor IoU reaches
``pos_ignore_thr`` and its gt is valid.

``approx_max_iou_assign_batch`` is the ApproxMaxIoU assigner of SABL
RetinaNet and Guided Anchoring: a cell's IoU with a gt is the largest
over its approx anchors, then the MaxIoU codes. ``point_assign_batch`` is
RepPoints' PointAssigner.

``priority_rank`` ranks entries by a fixed priority, the sampling of the
two-stage heads (``tpudet/models/dense_heads/rpn_head.py:104-117``).
"""
from __future__ import annotations

from typing import Sequence

import torch

from .bbox import bbox_cxcywh, bbox_overlaps

IGNORE = -2
NEGATIVE = -1
POINT_INF = 1e8  # the point assigner's distance off the gt's level


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
    if anchors.dim() == 2:
        anchors = anchors[None]
    return assign_by_ious(bbox_overlaps(anchors, gt_bboxes), gt_valid,
                          pos_iou_thr, neg_iou_thr, min_pos_iou,
                          match_low_quality, gt_max_assign_all)


def approx_max_ious(approx: torch.Tensor, gt_bboxes: torch.Tensor
                    ) -> torch.Tensor:
    """The ApproxMaxIoU assigner's IoUs: approx (A, K, 4), K approx
    anchors a cell, gt_bboxes (B, G, 4) -> (B, A, G), each cell's largest
    IoU over its K. The max is taken one approx anchor at a time, so no
    (B, A K, G) tensor is held (1.35 M approx anchors an image at the
    GA-RPN's strides 4-64 on 1344^2); a max is exact, so the values are
    tpudet's (``guided_anchor_head.py:269-273``)."""
    ious = None
    for k in range(approx.shape[1]):
        iou = bbox_overlaps(approx[None, :, k], gt_bboxes)
        ious = iou if ious is None else torch.maximum(ious, iou)
    return ious


def approx_max_iou_assign_batch(approx: torch.Tensor,
                                gt_bboxes: torch.Tensor,
                                gt_valid: torch.Tensor,
                                pos_iou_thr: float = 0.5,
                                neg_iou_thr: float = 0.4,
                                match_low_quality: bool = True
                                ) -> torch.Tensor:
    """The approx-max-IoU assignment of SABL RetinaNet
    (``sabl_retina_head.py:139-160``, ``match_low_quality``: every gt
    claims its best cells at any IoU above 0, the higher gt index on a
    tie) and of Guided Anchoring's shape targets
    (``guided_anchor_head.py:269-279, 465-475``, without it): MaxIoU codes
    over ``approx_max_ious``."""
    return assign_by_ious(approx_max_ious(approx, gt_bboxes), gt_valid,
                          pos_iou_thr, neg_iou_thr, 0.0, match_low_quality)


def assign_by_ious(ious: torch.Tensor,
                   gt_valid: torch.Tensor,
                   pos_iou_thr: float = 0.5,
                   neg_iou_thr: float = 0.4,
                   min_pos_iou: float = 0.0,
                   match_low_quality: bool = True,
                   gt_max_assign_all: bool = True) -> torch.Tensor:
    """The MaxIoU codes of (B, A, G) IoUs: ``max_iou_assign_batch``'s
    rules."""
    g = gt_valid.shape[1]
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
            rows = torch.arange(ious.shape[1], device=ious.device)
            is_tie = rows[None, :, None] == first[:, None, :]
        gt_ok = gt_valid & (gt_max >= min_pos_iou) & (gt_max > 0)
        is_best = is_tie & gt_ok[:, None, :]
        g_idx = torch.arange(g, dtype=torch.int32, device=ious.device)
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


def _uniform_candidates(pred_boxes, anchors, gt_bboxes, match_times: int):
    """(B, 2 k G) anchor indices of the uniform matching's candidate pairs
    in tpudet's flat order, their gts (2 k G,), and k."""
    num_g = gt_bboxes.shape[1]
    k = min(match_times, anchors.shape[0])
    gt_c = bbox_cxcywh(gt_bboxes)[:, :, None]  # (B, G, 1, 4)

    def nearest(boxes):  # (B, G, k) by a stable ascending sort
        cost = (bbox_cxcywh(boxes)[..., None, :, :] - gt_c).abs().sum(-1)
        return torch.sort(cost, dim=-1, stable=True).indices[..., :k]
    idx_pred = nearest(pred_boxes)
    idx_anchor = nearest(anchors[None])
    # (B, k, 2, G) flattened: [rank 0: predictions g0..gG-1, anchors
    # g0..gG-1, rank 1: ...], tpudet's cat((index, index1), 1).reshape(-1)
    flat = torch.stack([idx_pred.transpose(1, 2), idx_anchor.transpose(1, 2)],
                       dim=2).reshape(gt_bboxes.shape[0], -1)
    pair_gt = torch.arange(num_g, device=anchors.device).repeat(2 * k)
    return flat, pair_gt, k


def uniform_assign_batch(pred_boxes: torch.Tensor, anchors: torch.Tensor,
                         gt_bboxes: torch.Tensor, gt_valid: torch.Tensor,
                         match_times: int = 4, pos_ignore_thr: float = 0.15,
                         neg_ignore_thr: float = 0.7) -> torch.Tensor:
    """pred_boxes (B, A, 4) decoded, anchors (A, 4), gt_bboxes (B, G, 4)
    padded, gt_valid (B, G) -> (B, A) int64 codes."""
    b, num_a = pred_boxes.shape[:2]
    num_g = gt_bboxes.shape[1]
    flat, pair_gt, _ = _uniform_candidates(pred_boxes, anchors, gt_bboxes,
                                           match_times)
    order = torch.arange(1, flat.shape[1] + 1, device=flat.device)
    order = torch.where(gt_valid[:, pair_gt], order, 0)
    winner = torch.zeros((b, num_a), dtype=order.dtype,
                         device=flat.device).scatter_reduce_(
        1, flat, order, 'amax')
    win_gt = (winner - 1) % num_g  # the flat order -> its gt
    anchor_ious = bbox_overlaps(anchors[None], gt_bboxes)  # (B, A, G)
    anchor_ious = torch.where(gt_valid[:, None], anchor_ious,
                              anchor_ious.new_tensor(-1.0))
    win_iou = torch.gather(anchor_ious, 2, win_gt[..., None])[..., 0]
    pred_ious = bbox_overlaps(pred_boxes, gt_bboxes)
    pred_max = torch.where(gt_valid[:, None], pred_ious,
                           pred_ious.new_tensor(-1.0)).amax(dim=2)
    assigned = torch.where(pred_max > neg_ignore_thr, IGNORE, NEGATIVE)
    assigned = torch.where(
        winner > 0, torch.where(win_iou < pos_ignore_thr, IGNORE, win_gt),
        assigned)
    return torch.where(gt_valid.any(dim=1, keepdim=True), assigned, NEGATIVE)


def uniform_match_pairs_batch(pred_boxes: torch.Tensor,
                              anchors: torch.Tensor, gt_bboxes: torch.Tensor,
                              gt_valid: torch.Tensor, match_times: int = 4,
                              pos_ignore_thr: float = 0.15):
    """The uniform matching's candidate pairs: ``(pair_anchor (B, P),
    pair_gt (B, P), pair_pos (B, P))``, P = ``2 k G`` in tpudet's flat
    order."""
    flat, pair_gt, _ = _uniform_candidates(pred_boxes, anchors, gt_bboxes,
                                           match_times)
    pair_gt = pair_gt.expand_as(flat)
    anchor_ious = bbox_overlaps(anchors[None], gt_bboxes)  # (B, A, G)
    rows = torch.arange(flat.shape[0], device=flat.device)[:, None]
    pair_iou = anchor_ious[rows, flat, pair_gt]
    pair_pos = (pair_iou >= pos_ignore_thr) & gt_valid[rows, pair_gt]
    return flat, pair_gt, pair_pos


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


def point_assign_batch(points: torch.Tensor, lvl_ids: torch.Tensor,
                       gt_bboxes: torch.Tensor, gt_valid: torch.Tensor,
                       lvl_min: int, lvl_max: int, scale: float = 4.0,
                       pos_num: int = 1) -> torch.Tensor:
    """RepPoints' PointAssigner (``tpudet/models/dense_heads/
    reppoints_head.py:187-214``): points (P, 2) at ``lvl_ids`` (P,)
    (log2 of their strides), gt_bboxes (B, G, 4), gt_valid (B, G) -> (B,
    P) codes, ``NEGATIVE`` or a gt index.

    A gt's level is ``floor((log2(w / scale) + log2(h / scale)) / 2)``
    clipped to [lvl_min, lvl_max]; on it the gt takes its ``pos_num``
    points of least scale-normalised centre distance (ties to the lower
    point index: a stable sort, as ``lax.top_k``); a point several gts
    take goes to the closest of them, the lower gt index on a tie."""
    g_cx = (gt_bboxes[..., 0] + gt_bboxes[..., 2]) / 2
    g_cy = (gt_bboxes[..., 1] + gt_bboxes[..., 3]) / 2
    g_w = torch.clamp_min(gt_bboxes[..., 2] - gt_bboxes[..., 0], 1e-6)
    g_h = torch.clamp_min(gt_bboxes[..., 3] - gt_bboxes[..., 1], 1e-6)
    g_lvl = torch.clamp(torch.floor(
        (torch.log2(g_w / scale) + torch.log2(g_h / scale)) / 2.),
        lvl_min, lvl_max).to(lvl_ids.dtype)  # (B, G)
    dist = torch.sqrt(
        ((points[None, :, 0, None] - g_cx[:, None]) / g_w[:, None]) ** 2 +
        ((points[None, :, 1, None] - g_cy[:, None]) / g_h[:, None]) ** 2)
    near = (lvl_ids[None, :, None] == g_lvl[:, None]) & gt_valid[:, None]
    inf = dist.new_tensor(POINT_INF)
    dist = torch.where(near, dist, inf)  # (B, P, G)
    order = torch.sort(dist.transpose(1, 2), dim=-1, stable=True)[1]
    cand = torch.zeros_like(near).transpose(1, 2).scatter(
        -1, order[..., :pos_num], True).transpose(1, 2) & (dist < inf)
    best = torch.where(cand, dist, inf).argmin(dim=2)  # the first minimum
    return torch.where(cand.any(dim=2), best, NEGATIVE)

