"""The port's fast-bbox evaluator (``tpudet_torch/evaluation/mean_ap.py``)
against tpudet's, on the CPU.

Random detections and gts from numpy seeds: per image 0-8 gts over 4
classes (some crowd, some ignored, areas from the annotation), per class
0-12 detections, part of them jittered copies of gts so that the
thresholds from 0.5 to 0.95 all see matches, part of them with tied
scores. Tolerance: every report entry within 1e-9 (both compute the same
numpy in the same order), NaN where tpudet has NaN. The ground truth fed
back as detections gives ``map`` = 1.0.
"""
import math

import numpy as np
import pytest

from tpudet.evaluation import mean_ap as J
from tpudet_torch.evaluation import mean_ap as P

from . import torch_fixtures  # noqa: F401  (one intra-op thread)

NUM_CLASSES = 4
CLASSES = ('a', 'b', 'c', 'd')


def _box(rng, n, size=200.0):
    xy = rng.uniform(0, size, (n, 2))
    wh = rng.uniform(4, size / 2, (n, 2)) * rng.choice([0.2, 1, 2.5], (n, 1))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def _dataset(seed, n_img=12):
    rng = np.random.RandomState(seed)
    dets, annos = [], []
    for _ in range(n_img):
        g = rng.randint(0, 9)
        gt = _box(rng, g)
        labels = rng.randint(0, NUM_CLASSES, g).astype(np.int64)
        crowd = rng.uniform(size=g) < 0.15
        ignore = crowd | (rng.uniform(size=g) < 0.1)
        wh = gt[:, 2:] - gt[:, :2]
        area = (wh[:, 0] * wh[:, 1] * rng.uniform(0.6, 1.0, g)).astype(
            np.float32)
        annos.append(dict(gt_bboxes=gt, gt_labels=labels,
                          gt_attrs=dict(ignore=ignore, iscrowd=crowd,
                                        area=area)))
        per_cls = []
        for c in range(NUM_CLASSES):
            own = gt[labels == c]
            k = rng.randint(0, len(own) + 1)
            near = own[:k] + rng.normal(0, 3, (k, 4)).astype(np.float32)
            far = _box(rng, rng.randint(0, 8))
            boxes = np.concatenate([near, far])
            scores = rng.choice([0.9, 0.5, 0.3], len(boxes)) \
                if c == 0 else rng.uniform(0, 1, len(boxes))
            per_cls.append(np.concatenate(
                [boxes, scores[:, None]], 1).astype(np.float32))
        dets.append(per_cls)
    return dets, annos


def assert_same_report(got, ref, tol=1e-9):
    assert list(got) == list(ref)
    for k in ref:
        if math.isnan(ref[k]):
            assert math.isnan(got[k]), k
        else:
            assert abs(got[k] - ref[k]) <= tol, (k, got[k], ref[k])


@pytest.mark.parametrize('seed', range(4))
def test_coco_fast_bbox_eval_matches_tpudet(seed):
    dets, annos = _dataset(seed)
    ref = J.coco_fast_bbox_eval(dets, annos, classes=CLASSES)
    got = P.coco_fast_bbox_eval(dets, annos, classes=CLASSES)
    assert_same_report(got, ref)
    assert 0 < ref['map'] < 1


@pytest.mark.parametrize('seed', range(2))
def test_eval_map_flexible_matches_tpudet(seed):
    dets, annos = _dataset(seed + 10)
    kw = dict(iou_thrs=(0.3, 0.5, 0.7),
              breakdown=[dict(type='ScaleBreakdown',
                              scale_ranges=dict(small=(0, 40),
                                                big=(40, 1000)))],
              report_config=[('map', lambda x: x['breakdown'] == 'All'),
                             ('small', lambda x: x['breakdown'] == 'small'),
                             ('big', lambda x: x['breakdown'] == 'big')])
    assert_same_report(P.eval_map_flexible(dets, annos, **kw),
                       J.eval_map_flexible(dets, annos, **kw))
    # a head with more classes than the dataset defines
    assert_same_report(
        P.eval_map_flexible(dets, annos, classes=CLASSES[:2]),
        J.eval_map_flexible(dets, annos, classes=CLASSES[:2]))


def test_ground_truth_as_detections_gives_map_1():
    _, annos = _dataset(3)
    dets = []
    for a in annos:
        keep = ~a['gt_attrs']['ignore']
        dets.append([np.concatenate(
            [a['gt_bboxes'][keep & (a['gt_labels'] == c)],
             np.ones((int((keep & (a['gt_labels'] == c)).sum()), 1),
                     np.float32)], 1) for c in range(NUM_CLASSES)])
    got = P.coco_fast_bbox_eval(dets, annos, classes=CLASSES)
    assert got['map'] == got['map50'] == got['map75'] == 1.0
    assert_same_report(got, J.coco_fast_bbox_eval(dets, annos,
                                                  classes=CLASSES))


@pytest.mark.parametrize('matcher', ['match_coco', 'match_best_only'])
def test_matchers_match_tpudet(matcher):
    rng = np.random.RandomState(7)
    for _ in range(20):
        d, g = rng.randint(0, 15), rng.randint(0, 10)
        det, gt = _box(rng, d, 60), _box(rng, g, 60)
        crowd = rng.uniform(size=g) < 0.2
        ignore = crowd | (rng.uniform(size=g) < 0.2)
        iou = P.iou_coco(det, gt, crowd)
        np.testing.assert_array_equal(iou, J.iou_coco(det, gt, crowd))
        thrs = np.arange(0.05, 1.0, 0.1, dtype=np.float32)
        np.testing.assert_array_equal(
            getattr(P, matcher)(iou, thrs, ignore, crowd),
            getattr(J, matcher)(iou, thrs, ignore, crowd))


@pytest.mark.parametrize('mode', ['area', '11points'])
def test_average_precision_matches_tpudet(mode):
    rng = np.random.RandomState(8)
    rec = np.sort(rng.uniform(0, 1, (3, 20)), axis=1)
    prec = rng.uniform(0, 1, (3, 20))
    np.testing.assert_array_equal(P.average_precision(rec, prec, mode),
                                  J.average_precision(rec, prec, mode))
    assert P.average_precision(rec[0], prec[0], mode) == \
        J.average_precision(rec[0], prec[0], mode)
