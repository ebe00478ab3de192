"""VOC-protocol mAP: the port's own copy of ``tpudet/evaluation/
voc_map.py`` (``tpfp_default``, ``get_cls_results``, ``eval_map``), numpy
on the host. Per-class tp/fp with greedy best-IoU matching, ignore
regions, optional scale ranges, 'area' or VOC07 '11points' AP.

This is the evaluator behind ``XMLDataset.evaluate('mAP')``; the
COCO-protocol evaluator is ``mean_ap.py``'s (its crowd and matching
rules differ)."""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .mean_ap import average_precision
from .recall import _plain_iou


def tpfp_default(det_bboxes: np.ndarray,
                 gt_bboxes: np.ndarray,
                 gt_bboxes_ignore: Optional[np.ndarray] = None,
                 iou_thr: float = 0.5,
                 area_ranges=None) -> Tuple[np.ndarray, np.ndarray]:
    """tp/fp flags per det per scale range; a det whose best gt is an
    ignored one is neither."""
    if gt_bboxes_ignore is None:
        gt_bboxes_ignore = np.zeros((0, 4), np.float32)
    gt_ignore_inds = np.concatenate(
        (np.zeros(gt_bboxes.shape[0], dtype=bool),
         np.ones(gt_bboxes_ignore.shape[0], dtype=bool)))
    gt_bboxes = np.vstack((gt_bboxes, gt_bboxes_ignore))

    num_dets = det_bboxes.shape[0]
    num_gts = gt_bboxes.shape[0]
    if area_ranges is None:
        area_ranges = [(None, None)]
    num_scales = len(area_ranges)
    tp = np.zeros((num_scales, num_dets), dtype=np.float32)
    fp = np.zeros((num_scales, num_dets), dtype=np.float32)

    if gt_bboxes.shape[0] == 0:
        if area_ranges == [(None, None)]:
            fp[...] = 1
        else:
            det_areas = (det_bboxes[:, 2] - det_bboxes[:, 0]) * (
                det_bboxes[:, 3] - det_bboxes[:, 1])
            for i, (min_area, max_area) in enumerate(area_ranges):
                fp[i, (det_areas >= min_area) & (det_areas < max_area)] = 1
        return tp, fp

    ious = _plain_iou(det_bboxes[:, :4].astype(np.float32),
                      gt_bboxes.astype(np.float32))
    ious_max = ious.max(axis=1)
    ious_argmax = ious.argmax(axis=1)
    sort_inds = np.argsort(-det_bboxes[:, -1])
    for k, (min_area, max_area) in enumerate(area_ranges):
        gt_covered = np.zeros(num_gts, dtype=bool)
        if min_area is None:
            gt_area_ignore = np.zeros_like(gt_ignore_inds, dtype=bool)
        else:
            gt_areas = (gt_bboxes[:, 2] - gt_bboxes[:, 0]) * (
                gt_bboxes[:, 3] - gt_bboxes[:, 1])
            gt_area_ignore = (gt_areas < min_area) | (gt_areas >= max_area)
        for i in sort_inds:
            if ious_max[i] >= iou_thr:
                matched_gt = ious_argmax[i]
                if not (gt_ignore_inds[matched_gt]
                        or gt_area_ignore[matched_gt]):
                    if not gt_covered[matched_gt]:
                        gt_covered[matched_gt] = True
                        tp[k, i] = 1
                    else:
                        fp[k, i] = 1
            elif min_area is None:
                fp[k, i] = 1
            else:
                bbox = det_bboxes[i, :4]
                area = (bbox[2] - bbox[0]) * (bbox[3] - bbox[1])
                if min_area <= area < max_area:
                    fp[k, i] = 1
    return tp, fp


def get_cls_results(det_results, annotations, class_id):
    """Each image's dets, gts and ignored gts of one class."""
    cls_dets = [img_res[class_id] for img_res in det_results]
    cls_gts, cls_gts_ignore = [], []
    for ann in annotations:
        gt_inds = ann['labels'] == class_id
        cls_gts.append(ann['bboxes'][gt_inds, :])
        if ann.get('labels_ignore', None) is not None:
            ignore_inds = ann['labels_ignore'] == class_id
            cls_gts_ignore.append(ann['bboxes_ignore'][ignore_inds, :])
        else:
            cls_gts_ignore.append(np.empty((0, 4), dtype=np.float32))
    return cls_dets, cls_gts, cls_gts_ignore


def eval_map(det_results: List[List[np.ndarray]],
             annotations: List[Dict],
             scale_ranges: Optional[Sequence[Tuple]] = None,
             iou_thr: float = 0.5,
             dataset: Optional[str] = None) -> Tuple[float, List[Dict]]:
    """(mAP, per-class results).

    ``dataset='voc07'`` switches AP integration to 11-point.
    """
    assert len(det_results) == len(annotations)
    num_scales = len(scale_ranges) if scale_ranges is not None else 1
    num_classes = len(det_results[0])
    area_ranges = ([(rg[0]**2, rg[1]**2) for rg in scale_ranges]
                   if scale_ranges is not None else None)

    eval_results = []
    for i in range(num_classes):
        cls_dets, cls_gts, cls_gts_ignore = get_cls_results(
            det_results, annotations, i)
        tpfp = [
            tpfp_default(d, g, gi, iou_thr, area_ranges)
            for d, g, gi in zip(cls_dets, cls_gts, cls_gts_ignore)
        ]
        tp, fp = tuple(zip(*tpfp))
        num_gts = np.zeros(num_scales, dtype=int)
        for j, bbox in enumerate(cls_gts):
            if area_ranges is None:
                num_gts[0] += bbox.shape[0]
            else:
                gt_areas = (bbox[:, 2] - bbox[:, 0]) * (
                    bbox[:, 3] - bbox[:, 1])
                for k, (min_area, max_area) in enumerate(area_ranges):
                    num_gts[k] += np.sum((gt_areas >= min_area)
                                         & (gt_areas < max_area))
        cls_dets = np.vstack(cls_dets)
        num_dets = cls_dets.shape[0]
        sort_inds = np.argsort(-cls_dets[:, -1])
        tp = np.hstack(tp)[:, sort_inds]
        fp = np.hstack(fp)[:, sort_inds]
        tp = np.cumsum(tp, axis=1)
        fp = np.cumsum(fp, axis=1)
        eps = np.finfo(np.float32).eps
        recalls = tp / np.maximum(num_gts[:, np.newaxis], eps)
        precisions = tp / np.maximum((tp + fp), eps)
        if scale_ranges is None:
            recalls = recalls[0, :]
            precisions = precisions[0, :]
            num_gts = num_gts.item()
        mode = 'area' if dataset != 'voc07' else '11points'
        ap = average_precision(recalls, precisions, mode)
        eval_results.append({
            'num_gts': num_gts,
            'num_dets': num_dets,
            'recall': recalls,
            'precision': precisions,
            'ap': ap
        })

    if scale_ranges is not None:
        all_ap = np.vstack([res['ap'] for res in eval_results])
        all_num_gts = np.vstack([res['num_gts'] for res in eval_results])
        mean_ap = []
        for i in range(num_scales):
            if np.any(all_num_gts[:, i] > 0):
                mean_ap.append(all_ap[all_num_gts[:, i] > 0, i].mean())
            else:
                mean_ap.append(0.0)
    else:
        aps = [res['ap'] for res in eval_results if res['num_gts'] > 0]
        mean_ap = np.array(aps).mean().item() if aps else 0.0
    return mean_ap, eval_results
