"""The port's VOC-protocol mAP (``evaluation/voc_map.py``), proposal recall
(``evaluation/recall.py``) and ``XMLDataset.evaluate`` against tpudet's,
on the CPU.

Detections and ground truth come from numpy seeds: boxes jittered off the
gts (so IoUs spread around the thresholds), false positives, ignored gts,
empty images and classes, scores with ties. The known-answer cases of
``tests/test_eval/test_recall_voc.py`` run as cases of the parametrised
test here, through both packages.

Tolerance: every number within 1e-12 of tpudet's (absolute), flags and
counts exactly equal.
"""
import numpy as np
import pytest

import tpudet.evaluation.recall as jrecall
import tpudet.evaluation.voc_map as jvoc
from tpudet.data.custom import VOCDataset as JVOCDataset
from tpudet_torch.data import VOCDataset
from tpudet_torch.evaluation import recall, voc_map
from tpudet_torch.tools import dataset_formats as formats

from .test_torch_datasets import CLASSES, SHAPES, _coco
from . import torch_fixtures  # noqa: F401  (one intra-op thread)

ATOL = 1e-12


def assert_close(got, ref):
    if isinstance(ref, dict):
        assert set(got) == set(ref)
        for k in ref:
            assert_close(got[k], ref[k])
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert_close(g, r)
    else:
        g, r = np.asarray(got), np.asarray(ref)
        assert g.shape == r.shape and g.dtype == r.dtype
        np.testing.assert_allclose(g, r, rtol=0, atol=ATOL)


def _boxes(rng, n, size=200):
    xy = rng.uniform(0, size * 0.8, (n, 2))
    wh = rng.uniform(2, size * 0.4, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def _problem(seed, n_img=12, n_cls=4):
    """(det_results, annotations) in the VOC form."""
    rng = np.random.RandomState(seed)
    dets, anns = [], []
    for i in range(n_img):
        n = 0 if i == 3 else rng.randint(1, 9)
        gts = _boxes(rng, n)
        labels = rng.randint(0, n_cls, n)
        n_ig = rng.randint(0, 3)
        anns.append(dict(bboxes=gts, labels=labels,
                         bboxes_ignore=_boxes(rng, n_ig),
                         labels_ignore=rng.randint(0, n_cls, n_ig)))
        per_cls = []
        for c in range(n_cls):
            hit = gts[labels == c]
            jitter = hit + rng.normal(0, 6, hit.shape).astype(np.float32)
            fp = _boxes(rng, rng.randint(0, 4))
            boxes = np.concatenate([jitter, jitter[:1], fp])
            scores = np.round(rng.uniform(0, 1, len(boxes)), 1)
            per_cls.append(np.concatenate(
                [boxes, scores[:, None]], 1).astype(np.float32))
        if i == 5:
            per_cls[1] = np.zeros((0, 5), np.float32)
        dets.append(per_cls)
    return dets, anns


@pytest.mark.parametrize('mode', [
    dict(), dict(dataset='voc07'), dict(iou_thr=0.7),
    dict(scale_ranges=[(0, 32), (32, 96), (96, 1e5)]),
    dict(scale_ranges=[(0, 1e5)], dataset='voc07')],
    ids=['area', 'voc07', 'iou0.7', 'scale_ranges', 'scale_ranges_voc07'])
@pytest.mark.parametrize('seed', [0, 1])
def test_eval_map_matches_tpudet(seed, mode):
    dets, anns = _problem(seed)
    ref = jvoc.eval_map(dets, anns, **mode)
    got = voc_map.eval_map(dets, anns, **mode)
    assert_close(got[0], ref[0])
    assert_close(got[1], ref[1])
    assert 0 < np.mean(got[0]) < 1


@pytest.mark.parametrize('area_ranges', [None, [(0, 1000), (1000, 1e9)]])
def test_tpfp_default_matches_tpudet(area_ranges):
    dets, anns = _problem(2)
    for img_dets, ann in zip(dets, anns):
        for c, d in enumerate(img_dets):
            args = (d, ann['bboxes'][ann['labels'] == c],
                    ann['bboxes_ignore'][ann['labels_ignore'] == c], 0.5,
                    area_ranges)
            assert_close(voc_map.tpfp_default(*args),
                         jvoc.tpfp_default(*args))
    got = voc_map.get_cls_results(dets, anns, 2)
    ref = jvoc.get_cls_results(dets, anns, 2)
    assert_close(got, ref)


def _proposals(seed, n_img=10):
    rng = np.random.RandomState(seed)
    gts, props = [], []
    for i in range(n_img):
        g = _boxes(rng, 0 if i == 2 else rng.randint(1, 8))
        p = np.concatenate([g + rng.normal(0, 5, g.shape), _boxes(
            rng, rng.randint(0, 40))]).astype(np.float32)
        if i % 2:
            p = np.concatenate([p, rng.uniform(0, 1, (len(p), 1))],
                               1).astype(np.float32)
        gts.append(g)
        props.append(p[rng.permutation(len(p))])
    return gts, props


@pytest.mark.parametrize('budgets,thrs', [
    ([1, 10, 100], 0.5), (5, [0.5, 0.75]), ([3, 30], np.arange(0.5, 0.96,
                                                               0.05)),
    ([20], None)], ids=['list', 'int', 'coco_thrs', 'default_thr'])
def test_eval_recalls_matches_tpudet(budgets, thrs):
    gts, props = _proposals(0)
    ref = jrecall.eval_recalls(gts, props, budgets, thrs)
    got = recall.eval_recalls(gts, props, budgets, thrs)
    assert_close(got, ref)
    assert_close(recall.set_recall_param(budgets, thrs),
                 jrecall.set_recall_param(budgets, thrs))
    b = _boxes(np.random.RandomState(3), 6)
    assert_close(recall._plain_iou(b, b[:4]), jrecall._plain_iou(b, b[:4]))


def test_coco_proposal_fast_eval_matches_tpudet():
    dets, anns = _problem(4)
    rng = np.random.RandomState(5)
    annotations = []
    for a in anns:
        n = len(a['bboxes'])
        ignore = rng.uniform(size=n) < 0.2
        annotations.append(dict(
            gt_bboxes=a['bboxes'], gt_labels=a['labels'],
            gt_attrs=dict(ignore=ignore, iscrowd=ignore,
                          area=np.ones(n, np.float32))))
    for results in (dets, [np.vstack(d) for d in dets]):
        for nums in ((100, 300, 1000), (1, 5)):
            ref = jrecall.coco_proposal_fast_eval(results, annotations, nums)
            got = recall.coco_proposal_fast_eval(results, annotations, nums)
            assert list(got) == list(ref)
            assert_close(got, ref)


def _known_perfect_and_none(ev):
    gts = [np.array([[0, 0, 10, 10], [20, 20, 40, 40]], np.float32)]
    props = [np.array([[0, 0, 10, 10, 0.9], [20, 20, 40, 40, 0.8],
                       [50, 50, 60, 60, 0.7]], np.float32)]
    zero = [np.array([[50, 50, 60, 60, 1.0]], np.float32)]
    out = (ev.eval_recalls(gts, props, [3], [0.5, 0.9]),
           ev.eval_recalls(gts, props, [1], [0.5]),
           ev.eval_recalls(gts, zero, [1], [0.5]))
    np.testing.assert_allclose(out[0], [[1.0, 1.0]])
    np.testing.assert_allclose(out[1], [[0.5]])
    np.testing.assert_allclose(out[2], [[0.0]])
    return out


def _known_proposal_fast(ev):
    ann = dict(gt_bboxes=np.array([[0, 0, 10, 10]], np.float32),
               gt_labels=np.array([0]),
               gt_attrs=dict(ignore=np.array([False]),
                             iscrowd=np.array([False]),
                             area=np.array([100.0], np.float32)))
    rep = ev.coco_proposal_fast_eval(
        [[np.array([[0, 0, 10, 10, 0.9]], np.float32)]], [ann])
    assert rep['AR@100'] == 1.0 and rep['AR@1000'] == 1.0
    return rep


def _known_tpfp_ignore_region(ev):
    det = np.array([[0, 0, 10, 10, 0.9]], np.float32)
    gt = np.zeros((0, 4), np.float32)
    gt_ig = np.array([[0, 0, 10, 10]], np.float32)
    tp, fp = ev.tpfp_default(det, gt, gt_ig, iou_thr=0.5)
    assert tp.sum() == 0 and fp.sum() == 0
    tp2, fp2 = ev.tpfp_default(det, gt, None, iou_thr=0.5)
    assert fp2.sum() == 1
    return tp, fp, tp2, fp2


def _known_voc07_mode(ev):
    ann = dict(bboxes=np.array([[0, 0, 10, 10]], np.float32),
               labels=np.array([0]))
    dets = [[np.array([[0, 0, 10, 10, 0.9]], np.float32)]]
    m_area, _ = ev.eval_map(dets, [ann], iou_thr=0.5)
    m_11, _ = ev.eval_map(dets, [ann], iou_thr=0.5, dataset='voc07')
    assert abs(m_area - 1.0) < 1e-6 and abs(m_11 - 1.0) < 1e-6
    return m_area, m_11


KNOWN = {
    'eval_recalls_perfect_and_none': (_known_perfect_and_none, 'recall'),
    'proposal_fast_eval': (_known_proposal_fast, 'recall'),
    'tpfp_ignore_region': (_known_tpfp_ignore_region, 'voc'),
    'eval_map_voc07_mode': (_known_voc07_mode, 'voc'),
}


@pytest.mark.parametrize('case', sorted(KNOWN))
def test_known_answers_of_tpudets_recall_voc_tests(case):
    """``tests/test_eval/test_recall_voc.py``'s cases: the same answer
    from both packages."""
    fn, kind = KNOWN[case]
    ref = fn(jrecall if kind == 'recall' else jvoc)
    got = fn(recall if kind == 'recall' else voc_map)
    assert_close(got, ref)


@pytest.fixture(scope='module')
def voc_pair(tmp_path_factory):
    """The shapes val set as a VOC tree, some objects difficult, read by
    both packages' ``VOCDataset`` (the shapes classes)."""
    d = tmp_path_factory.mktemp('voc')
    coco = _coco()
    split = formats.write_voc(coco, f'{SHAPES}/val/images', str(d),
                              difficult=lambda a: a['id'] % 6 == 0)
    args = dict(ann_file=split, img_prefix=str(d), pipeline=[],
                test_mode=True, classes=CLASSES)
    return JVOCDataset(**args), VOCDataset(**args, device='cpu')


def _voc_results(ds, seed):
    """Detections near each image's gts and ignored gts, with misses and
    false positives."""
    rng = np.random.RandomState(seed)
    out = []
    for info in ds.data_infos:
        ann = info['ann']
        per_cls = []
        for c in range(len(CLASSES)):
            boxes = np.concatenate([ann['bboxes'][ann['labels'] == c],
                                    ann['bboxes_ignore'][
                                        ann['labels_ignore'] == c]])
            boxes = boxes[rng.uniform(size=len(boxes)) < 0.8]
            boxes = boxes + rng.normal(0, 8, boxes.shape)
            boxes = np.concatenate([boxes, _boxes(rng, rng.randint(0, 3),
                                                  300)])
            per_cls.append(np.concatenate(
                [boxes, rng.uniform(0, 1, (len(boxes), 1))],
                1).astype(np.float32))
        out.append(per_cls)
    return out


@pytest.mark.parametrize('kw', [
    dict(metric='mAP'), dict(metric='mAP', year='2012'),
    dict(metric='mAP', iou_thr=0.75),
    dict(metric='mAP', scale_ranges=[(0, 64), (64, 1e5)]),
    dict(metric='recall'), dict(metric='recall', proposal_nums=(1, 10),
                                iou_thr=[0.5, 0.7])],
    ids=['mAP', 'mAP_2012', 'mAP_iou0.75', 'mAP_scale_ranges', 'recall',
         'recall_budgets'])
def test_voc_dataset_evaluate_matches_tpudet(voc_pair, kw):
    ref_ds, ds = voc_pair
    results = _voc_results(ds, 0)
    if 'scale_ranges' in kw:
        with pytest.raises(TypeError):  # tpudet's float() of a list
            ref_ds.evaluate(results, **kw)
        with pytest.raises(TypeError):
            ds.evaluate(results, **kw)
        return
    ref = ref_ds.evaluate(results, **kw)
    got = ds.evaluate(results, **kw)
    assert list(got) == list(ref)
    assert_close(got, ref)
    assert all(0 < v < 1 for v in got.values())
    with pytest.raises(KeyError):
        ds.evaluate(results, metric='bbox')
