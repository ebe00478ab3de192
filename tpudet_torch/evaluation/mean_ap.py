"""Fast flexible COCO-protocol mAP evaluator: the port's own copy of
``tpudet/evaluation/mean_ap.py:30-483`` (numpy on the host).

Rebuild of the reference's pycocotools-free evaluator
(mmdet/core/evaluation/mean_ap_flexible.py:98-302) and its Cython kernels
(mmdet/ops/eval_utils/iou/iou_coco.pyx, match/match_coco.pyx):

- :func:`iou_coco`: det x gt IoU where crowd gts use det-area-only union
  (iou_coco.pyx:44-48), vectorized numpy;
- :func:`match_coco`: greedy per-threshold det->gt matching with
  ignore/crowd semantics (match_coco.pyx:27-55). The sequential gt scan
  reduces to: best available *regular* gt with IoU >= thr wins, else the
  best available *ignored* gt; matched non-crowd gts become unavailable,
  crowd gts stay reusable;
- breakdowns (NoBreakdown / ScaleBreakdown) and accumulation identical to
  mean_ap_flexible.py:39-276.

``coco_fast_bbox_eval`` mirrors the 'fast-bbox' metric wiring
(mmdet/datasets/coco.py:465-496): IoU .50:.95, S/M/L scale breakdowns,
map/map50/map75/s/m/l report; ``coco_fast_segm_eval`` the same with
mask IoUs (``core/mask.py`` ``mask_iou_matrix``, from the RLEs' runs; the
gts rasterized by the port's cv2-equal fill). tpudet's optional C++
matchers are host code with the same results and are not carried.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List

import numpy as np

from ..core.mask import mask_iou_matrix, segmentation_to_bitmap


def average_precision(recalls, precisions, mode='area'):
    """AP from PR points (reference mean_ap.py:12-63 semantics)."""
    no_scale = recalls.ndim == 1
    if no_scale:
        recalls = recalls[None]
        precisions = precisions[None]
    num_scales = recalls.shape[0]
    ap = np.zeros(num_scales, dtype=np.float32)
    if mode == 'area':
        zeros = np.zeros((num_scales, 1), dtype=recalls.dtype)
        ones = np.ones((num_scales, 1), dtype=recalls.dtype)
        mrec = np.hstack((zeros, recalls, ones))
        mpre = np.hstack((zeros, precisions, zeros))
        mpre = np.maximum.accumulate(mpre[:, ::-1], axis=1)[:, ::-1]
        for i in range(num_scales):
            ind = np.where(mrec[i, 1:] != mrec[i, :-1])[0]
            ap[i] = np.sum(
                (mrec[i, ind + 1] - mrec[i, ind]) * mpre[i, ind + 1])
    elif mode == '11points':
        for i in range(num_scales):
            for thr in np.arange(0, 1 + 1e-3, 0.1):
                precs = precisions[i, recalls[i, :] >= thr]
                ap[i] += precs.max() if precs.size > 0 else 0
        ap /= 11
    else:
        raise ValueError(f'unknown mode {mode}')
    return ap[0] if no_scale else ap


def iou_coco(det_boxes: np.ndarray, gt_boxes: np.ndarray,
             is_crowd: np.ndarray) -> np.ndarray:
    """(D, G) IoU matrix; crowd gts use det-area union (COCO semantics)."""
    det_boxes = det_boxes.astype(np.float32)
    gt_boxes = gt_boxes.astype(np.float32)
    det_area = ((det_boxes[:, 2] - det_boxes[:, 0]) *
                (det_boxes[:, 3] - det_boxes[:, 1]))
    gt_area = ((gt_boxes[:, 2] - gt_boxes[:, 0]) *
               (gt_boxes[:, 3] - gt_boxes[:, 1]))
    tl = np.maximum(det_boxes[:, None, :2], gt_boxes[None, :, :2])
    br = np.minimum(det_boxes[:, None, 2:], gt_boxes[None, :, 2:])
    wh = np.clip(br - tl, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = np.where(is_crowd[None, :], det_area[:, None],
                     det_area[:, None] + gt_area[None, :] - inter)
    union = np.maximum(union, 1e-7)
    iou = inter / union
    return np.where(inter > 0, iou, 0.).astype(np.float32)


def match_coco(iou_mat: np.ndarray, iou_thrs: np.ndarray,
               is_ignore: np.ndarray, is_crowd: np.ndarray) -> np.ndarray:
    """Greedy COCO matching; returns (T, D) matched gt index or -1.

    Dets must already be sorted by descending score (the caller sorts, as
    in mean_ap_flexible.py:132-134).
    """
    num_det, num_gt = iou_mat.shape
    num_thr = len(iou_thrs)
    matched = np.full((num_thr, num_det), -1, dtype=np.int32)
    if num_gt == 0:
        return matched
    regular = ~is_ignore
    neg = -np.inf

    def _last_argmax(x):
        # the reference scan replaces on IoU >= best-so-far, so among equal
        # maxima the LAST gt wins (match_coco.pyx:41-51)
        return num_gt - 1 - int(np.argmax(x[::-1]))

    for t in range(num_thr):
        thr = iou_thrs[t]
        gt_avail = np.ones(num_gt, dtype=bool)
        for d in range(num_det):
            ious = iou_mat[d]
            reg_ious = np.where(gt_avail & regular, ious, neg)
            best_reg = _last_argmax(reg_ious)
            if reg_ious[best_reg] >= thr:
                m = best_reg
            else:
                ign_ious = np.where(gt_avail & is_ignore, ious, neg)
                best_ign = _last_argmax(ign_ious)
                if ign_ious[best_ign] >= thr:
                    m = best_ign
                else:
                    continue
            matched[t, d] = m
            if not is_crowd[m]:
                gt_avail[m] = False
    return matched


def match_best_only(iou_mat: np.ndarray, iou_thrs: np.ndarray,
                    is_ignore: np.ndarray,
                    is_crowd: np.ndarray) -> np.ndarray:
    """Best-only matching variant (reference
    mmdet/ops/eval_utils/match/match_best_only.pyx): a det may only match
    the regular gt that is its global-best regular IoU (first such
    available gt wins and the scan stops); ignored gts behave like
    match_coco (best available above threshold, last-max ties).
    """
    num_det, num_gt = iou_mat.shape
    matched = np.full((len(iou_thrs), num_det), -1, dtype=np.int32)
    if num_gt == 0:
        return matched
    regular = ~is_ignore
    best_reg = np.where(regular.any(),
                        np.max(np.where(regular[None, :], iou_mat, -np.inf),
                               axis=1), -np.inf)
    for t, thr0 in enumerate(iou_thrs):
        gt_avail = np.ones(num_gt, dtype=bool)
        for d in range(num_det):
            thr = thr0
            m = -1
            for g in range(num_gt):
                if not gt_avail[g] and not is_crowd[g]:
                    continue
                if m > -1 and regular[m] and is_ignore[g]:
                    continue
                if iou_mat[d, g] < thr:
                    continue
                if regular[g]:
                    if iou_mat[d, g] == best_reg[d]:
                        m = g
                        break
                else:
                    thr = iou_mat[d, g]
                    m = g
            if m != -1:
                matched[t, d] = m
                if not is_crowd[m]:
                    gt_avail[m] = False
    return matched


class NoBreakdown:
    """Single 'All' breakdown (reference mean_ap_flexible.py:39-66)."""

    def __init__(self, classes, apply_to=None, **kwargs):
        if apply_to is None:
            apply_to = classes
        self.classes = classes
        self.apply_to = apply_to
        self.names = ['All']

    def breakdown_flags(self, boxes, attrs=None):
        flags = np.ones((1, len(boxes)), dtype=bool)
        if attrs is not None and 'ignore' in attrs:
            flags[:, attrs['ignore']] = False
        return flags

    def breakdown(self, boxes, label, attrs=None):
        flags = self.breakdown_flags(boxes, attrs)
        if self.classes is None or self.classes[label] in self.apply_to:
            return flags
        return flags[:0]

    def breakdown_names(self, label):
        if self.classes is None or self.classes[label] in self.apply_to:
            return list(self.names)
        return []


class ScaleBreakdown(NoBreakdown):
    """Area-range breakdowns (S/M/L) (reference :69-95); gt area comes from
    the annotation 'area' attr when present (COCO convention)."""

    def __init__(self, scale_ranges, classes, apply_to=None, **kwargs):
        super().__init__(classes, apply_to)
        self.names = []
        self.area_ranges = []
        for k, (smin, smax) in scale_ranges.items():
            self.names.append(k)
            self.area_ranges.append((smin * smin, smax * smax))

    def breakdown_flags(self, boxes, attrs=None):
        if attrs is not None and 'area' in attrs:
            area = attrs['area']
        else:
            wh = boxes[:, 2:] - boxes[:, :2]
            area = wh[:, 0] * wh[:, 1]
        flags = np.zeros((len(self.area_ranges), len(boxes)), dtype=bool)
        for i, (amin, amax) in enumerate(self.area_ranges):
            flags[i] = (area >= amin) & (area < amax)
        if attrs is not None and 'ignore' in attrs:
            flags[:, attrs['ignore']] = False
        return flags


BREAKDOWNS = {'NoBreakdown': NoBreakdown, 'ScaleBreakdown': ScaleBreakdown}


class FlexibleStatisticsEval:
    """Per-image per-class TP statistics -> PR curves -> AP
    (reference FlexibleStatisticsEval, mean_ap_flexible.py:98-276)."""

    def __init__(self, classes, iou_thrs, breakdown=()):
        self.classes = classes
        self.iou_thrs = np.asarray(iou_thrs, dtype=np.float32)
        self.breakdown = [NoBreakdown(classes)]
        for bkd in breakdown:
            bkd = dict(bkd)
            cls_name = bkd.pop('type')
            self.breakdown.append(BREAKDOWNS[cls_name](classes=classes,
                                                       **bkd))

    def statistics_single(self, det: List[np.ndarray], anno: Dict,
                          det_segms=None):
        """``det_segms`` (per-class lists of RLE dicts, parallel to
        ``det``) switches the matching to mask IoU, the 'segm' metric; it
        needs ``anno['gt_masks']`` (COCO segmentations) and
        ``anno['img_shape']`` (h, w)."""
        tp_score_info = []
        num_cls = len(det)
        # A head may predict more classes than the dataset defines (e.g.
        # an 80-class head evaluated on a 1-class dataset). The reference
        # drops those detections entirely (CocoDataset.evaluate iterates
        # range(len(self.cat_ids)), mmdet/datasets/coco.py:303-310), so
        # clamp instead of indexing out of range.
        if self.classes is not None:
            num_cls = min(num_cls, len(self.classes))
        num_thr = len(self.iou_thrs)
        gt_bboxes = anno['gt_bboxes']
        gt_labels = anno['gt_labels']
        gt_attrs = anno['gt_attrs']
        gt_bitmaps = None
        if det_segms is not None:
            h, w = anno['img_shape'][:2]
            gt_bitmaps = [segmentation_to_bitmap(s, h, w)
                          for s in anno['gt_masks']]

        for cls in range(num_cls):
            cls_name = self.classes[cls] if self.classes is not None else cls
            cls_det = det[cls]
            sort_ind = np.argsort(-cls_det[:, -1], kind='stable')
            cls_det_bboxes = cls_det[sort_ind, :-1]
            cls_det_scores = cls_det[sort_ind, -1]
            num_dets = len(cls_det_scores)

            msk = gt_labels == cls
            cls_gt_bboxes = gt_bboxes[msk]
            cls_attrs = {k: v[msk] for k, v in gt_attrs.items()}
            ignore_msk = cls_attrs.get(
                'ignore', np.zeros(len(cls_gt_bboxes), bool))
            crowd_msk = cls_attrs.get(
                'iscrowd', np.zeros(len(cls_gt_bboxes), bool))
            num_ignore = int(ignore_msk.sum())
            num_gts = len(cls_gt_bboxes) - num_ignore

            det_bkd, gt_bkd, bkd_names = [], [], []
            for fun in self.breakdown:
                det_bkd.append(fun.breakdown(cls_det_bboxes, cls))
                gt_bkd.append(fun.breakdown(cls_gt_bboxes, cls, cls_attrs))
                bkd_names += fun.breakdown_names(cls)
            det_bkd = np.concatenate(det_bkd, axis=0)
            gt_bkd = np.concatenate(gt_bkd, axis=0)
            num_bkd = gt_bkd.shape[0]
            gt_count = [int(gt_bkd[i].sum()) for i in range(num_bkd)]

            tp = np.zeros((num_thr, num_dets), dtype=bool)
            if (num_gts + num_ignore) == 0 or num_dets == 0:
                for i in range(num_bkd):
                    tp_score_info.append(
                        (cls_name, bkd_names[i], gt_count[i], cls_det_scores,
                         tp, np.repeat(det_bkd[i:i + 1], num_thr, axis=0)))
                continue

            if det_segms is not None:
                cls_segms = [det_segms[cls][i] for i in sort_ind]
                cls_gt_masks = [m for m, keep in zip(gt_bitmaps, msk)
                                if keep]
                ious = mask_iou_matrix(cls_segms, cls_gt_masks, crowd_msk)
            else:
                ious = iou_coco(cls_det_bboxes, cls_gt_bboxes, crowd_msk)
            for i in range(num_bkd):
                gt_in_bkd = gt_bkd[i]
                matched = match_coco(ious, self.iou_thrs, ~gt_in_bkd,
                                     crowd_msk)
                tp = matched > -1
                # fp: unmatched det inside breakdown; tp: matched to an
                # in-breakdown gt (reference :196-201)
                msk_fp = det_bkd[i:i + 1] & (matched == -1)
                msk_tp = gt_in_bkd[matched] & (matched > -1)
                tp_score_info.append((cls_name, bkd_names[i], gt_count[i],
                                      cls_det_scores, tp, msk_fp | msk_tp))
        return tp_score_info

    def statistics_accumulate(self, item):
        cls, bkd, num_gt, score, tp, bkd_msk = item
        out = []
        rank = np.argsort(-score, kind='stable')
        tp = tp[:, rank]
        bkd_msk = bkd_msk[:, rank]
        for t, iou_thr in enumerate(self.iou_thrs):
            tpcum = tp[t, bkd_msk[t]].cumsum()
            num_det = len(tpcum)
            recall = tpcum / max(num_gt, 1e-7)
            precision = tpcum / np.arange(1, num_det + 1)
            m_ap = average_precision(recall, precision)
            key = dict(class_name=cls, breakdown=bkd,
                       iou_threshold=float(iou_thr))
            val = dict(num_det=num_det, num_gt=num_gt,
                       recall=recall.max() if num_det else 0, mAP=m_ap)
            out.append((key, val))
        return out

    def statistics_eval(self, det_results, annotations, det_segms=None):
        if det_segms is None:
            det_segms = [None] * len(det_results)
        tp_score_infos = [
            self.statistics_single(d, a, s)
            for d, a, s in zip(det_results, annotations, det_segms)
        ]
        merged = []
        for items in zip(*tp_score_infos):
            cls, bkd, num_gt, score, tp, bkd_msk = tuple(zip(*items))
            merged.append((cls[0], bkd[0], sum(num_gt),
                           np.concatenate(score),
                           np.concatenate(tp, axis=1),
                           np.concatenate(bkd_msk, axis=1)))
        results = []
        for item in merged:
            results += self.statistics_accumulate(item)
        return results

    def report(self, eval_result_list, group_by):
        report = OrderedDict()
        for name, cond in group_by:
            vals = [
                v['mAP'] for k, v in eval_result_list
                if cond(k) and v['num_gt'] > 0
            ]
            report[name] = float(np.mean(vals)) if vals else float('nan')
        return report


def eval_map_flexible(det_results,
                      annotations,
                      iou_thrs=(0.5,),
                      breakdown=(),
                      classes=None,
                      det_segms=None,
                      report_config=(('map',
                                      lambda x: x['breakdown'] == 'All'),)):
    """Reference eval_map_flexible (mean_ap_flexible.py:279-302).

    Args:
        det_results: per image, per class (n, 5) arrays [x1 y1 x2 y2 score].
        annotations: per image dicts with gt_bboxes (xyxy), gt_labels and
            gt_attrs {ignore, iscrowd, area}.
    """
    assert len(det_results) == len(annotations)
    fse = FlexibleStatisticsEval(classes, iou_thrs, breakdown)
    results = fse.statistics_eval(det_results, annotations, det_segms)
    return fse.report(results, report_config)


def coco_fast_bbox_eval(det_results, annotations, classes=None):
    """'fast-bbox' metric: COCO ious + S/M/L breakdowns
    (reference mmdet/datasets/coco.py:465-496)."""
    return eval_map_flexible(
        det_results,
        annotations,
        iou_thrs=[0.5 + 0.05 * x for x in range(10)],
        breakdown=[
            dict(type='ScaleBreakdown',
                 scale_ranges=dict(Scale_S=(0, 32), Scale_M=(32, 96),
                                   Scale_L=(96, 10000)))
        ],
        report_config=[
            ('map', lambda x: x['breakdown'] == 'All'),
            ('map50', lambda x: x['iou_threshold'] == 0.5 and x['breakdown']
             == 'All'),
            ('map75', lambda x: x['iou_threshold'] == 0.75 and x['breakdown']
             == 'All'),
            ('s_map', lambda x: x['breakdown'] == 'Scale_S'),
            ('m_map', lambda x: x['breakdown'] == 'Scale_M'),
            ('l_map', lambda x: x['breakdown'] == 'Scale_L'),
        ],
        classes=classes)


def coco_fast_segm_eval(det_results, det_segms, annotations, classes=None):
    """'fast-segm' metric: instance-mask mAP with COCO ious and the S/M/L
    breakdowns (``tpudet/evaluation/mean_ap.py:449-483``): the flexible
    evaluator on mask IoUs.

    Args:
        det_results: per image, per class (n, 5) bbox arrays (the scores
            rank; the scale breakdown uses the boxes).
        det_segms: per image, per class lists of RLE dicts aligned with
            det_results' rows.
        annotations: per image dicts with gt_bboxes/gt_labels/gt_attrs,
            gt_masks (COCO segmentations) and img_shape (h, w).
    """
    return eval_map_flexible(
        det_results,
        annotations,
        iou_thrs=[0.5 + 0.05 * x for x in range(10)],
        breakdown=[
            dict(type='ScaleBreakdown',
                 scale_ranges=dict(Scale_S=(0, 32), Scale_M=(32, 96),
                                   Scale_L=(96, 10000)))
        ],
        det_segms=det_segms,
        report_config=[
            ('segm_map', lambda x: x['breakdown'] == 'All'),
            ('segm_map50', lambda x: x['iou_threshold'] == 0.5 and
             x['breakdown'] == 'All'),
            ('segm_map75', lambda x: x['iou_threshold'] == 0.75 and
             x['breakdown'] == 'All'),
            ('segm_s_map', lambda x: x['breakdown'] == 'Scale_S'),
            ('segm_m_map', lambda x: x['breakdown'] == 'Scale_M'),
            ('segm_l_map', lambda x: x['breakdown'] == 'Scale_L'),
        ],
        classes=classes)
