"""Proposal recall: the port's own copy of ``tpudet/evaluation/recall.py``
(``_plain_iou``, ``_recalls``, ``set_recall_param``, ``eval_recalls``,
``coco_proposal_fast_eval``), numpy on the host.

Behind ``XMLDataset.evaluate('recall')`` and the test CLI's
``proposal_fast`` metric (AR@100/300/1000 over IoU 0.5:0.95).
"""
from __future__ import annotations

from collections.abc import Sequence
from typing import List, Optional

import numpy as np


def _plain_iou(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """(N, M) IoU with the plain union (no +1 on widths)."""
    if boxes1.size == 0 or boxes2.size == 0:
        return np.zeros((boxes1.shape[0], boxes2.shape[0]), np.float32)
    a1 = ((boxes1[:, 2] - boxes1[:, 0]) * (boxes1[:, 3] - boxes1[:, 1]))
    a2 = ((boxes2[:, 2] - boxes2[:, 0]) * (boxes2[:, 3] - boxes2[:, 1]))
    tl = np.maximum(boxes1[:, None, :2], boxes2[None, :, :2])
    br = np.minimum(boxes1[:, None, 2:4], boxes2[None, :, 2:4])
    wh = np.clip(br - tl, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = np.maximum(a1[:, None] + a2[None, :] - inter, 1e-7)
    return (inter / union).astype(np.float32)


def _recalls(all_ious, proposal_nums, thrs):
    """Greedy one-to-one gt-proposal matching at each proposal budget:
    the best remaining pair first; the recall of each budget and IoU
    threshold."""
    img_num = len(all_ious)
    total_gt_num = sum(ious.shape[0] for ious in all_ious)

    _ious = np.zeros((proposal_nums.size, total_gt_num), dtype=np.float32)
    for k, proposal_num in enumerate(proposal_nums):
        tmp_ious = np.zeros(0)
        for i in range(img_num):
            ious = all_ious[i][:, :proposal_num].copy()
            gt_ious = np.zeros((ious.shape[0]))
            if ious.size == 0:
                tmp_ious = np.hstack((tmp_ious, gt_ious))
                continue
            for j in range(ious.shape[0]):
                gt_max_overlaps = ious.argmax(axis=1)
                max_ious = ious[np.arange(0, ious.shape[0]),
                                gt_max_overlaps]
                gt_idx = max_ious.argmax()
                gt_ious[j] = max_ious[gt_idx]
                box_idx = gt_max_overlaps[gt_idx]
                ious[gt_idx, :] = -1
                ious[:, box_idx] = -1
            tmp_ious = np.hstack((tmp_ious, gt_ious))
        _ious[k, :] = tmp_ious

    _ious = np.fliplr(np.sort(_ious, axis=1))
    recalls = np.zeros((proposal_nums.size, thrs.size))
    for i, thr in enumerate(thrs):
        recalls[:, i] = (_ious >= thr).sum(axis=1) / float(
            max(total_gt_num, 1))
    return recalls


def set_recall_param(proposal_nums, iou_thrs):
    if isinstance(proposal_nums, Sequence):
        _proposal_nums = np.array(proposal_nums)
    elif isinstance(proposal_nums, int):
        _proposal_nums = np.array([proposal_nums])
    else:
        _proposal_nums = proposal_nums
    if iou_thrs is None:
        _iou_thrs = np.array([0.5])
    elif isinstance(iou_thrs, Sequence):
        _iou_thrs = np.array(iou_thrs)
    elif isinstance(iou_thrs, float):
        _iou_thrs = np.array([iou_thrs])
    else:
        _iou_thrs = iou_thrs
    return _proposal_nums, _iou_thrs


def eval_recalls(gts: List[np.ndarray],
                 proposals: List[np.ndarray],
                 proposal_nums=None,
                 iou_thrs=0.5) -> np.ndarray:
    """Recall matrix (num_proposal_budgets, num_iou_thrs); (k, 5)
    proposals are ranked by score first."""
    img_num = len(gts)
    assert img_num == len(proposals)
    proposal_nums, iou_thrs = set_recall_param(proposal_nums, iou_thrs)

    all_ious = []
    for i in range(img_num):
        if proposals[i].ndim == 2 and proposals[i].shape[1] == 5:
            scores = proposals[i][:, 4]
            sort_idx = np.argsort(scores)[::-1]
            img_proposal = proposals[i][sort_idx, :]
        else:
            img_proposal = proposals[i]
        prop_num = min(img_proposal.shape[0], proposal_nums[-1])
        if gts[i] is None or gts[i].shape[0] == 0:
            ious = np.zeros((0, img_proposal.shape[0]), dtype=np.float32)
        else:
            ious = _plain_iou(gts[i].astype(np.float32),
                              img_proposal[:prop_num, :4].astype(np.float32))
        all_ious.append(ious)
    return _recalls(all_ious, proposal_nums, iou_thrs)


def coco_proposal_fast_eval(results, annotations,
                            proposal_nums=(100, 300, 1000)):
    """'proposal_fast' metric: average recall over IoU .5:.95 at each
    proposal budget.

    Args:
        results: per-image (k, 4/5) proposal arrays OR per-class det lists
            (flattened to proposals by concatenation).
        annotations: per-image dicts with gt_bboxes (and gt_attrs whose
            ignored gts, crowd ones among them, are left out).
    """
    gts = []
    for a in annotations:
        keep = ~(a['gt_attrs'].get('ignore',
                                   np.zeros(len(a['gt_bboxes']), bool)))
        gts.append(a['gt_bboxes'][keep])
    props = []
    for r in results:
        if isinstance(r, list):  # per-class det lists -> one proposal set
            r = np.vstack([x for x in r if len(x)]) if any(
                len(x) for x in r) else np.zeros((0, 5), np.float32)
        props.append(np.asarray(r))
    iou_thrs = np.arange(0.5, 0.96, 0.05)
    recalls = eval_recalls(gts, props, list(proposal_nums), iou_thrs)
    ar = recalls.mean(axis=1)
    return {f'AR@{n}': float(ar[i]) for i, n in enumerate(proposal_nums)}
