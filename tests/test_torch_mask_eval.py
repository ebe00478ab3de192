"""Mask inference and the segm metric in the port against tpudet, on the
CPU, from numpy seeds: the paste, the RLEs, the mask IoU, the segm mAP,
``single_device_test(with_masks=True)``, ``inference_detector`` with
masks, ``results2json``'s ``segm.json`` and the test CLI's segm report.

Tolerances:

- the paste (``paste_masks``, a batch, and ``paste_mask_probs``, numpy):
  equal to tpudet's ``cv2.resize`` paste on every pixel, over boxes inside,
  across and outside the image, sub-pixel, and windows of exactly half
  the mask (14 x 14), at three thresholds;
- ``encode_rle``/``encode_rle_batch``/``decode_rle``/``rle_area``: equal
  to tpudet's; ``mask_iou_matrix`` (from the runs): equal, crowd gts too;
- ``coco_fast_segm_eval``: the report equal to tpudet's; the segm results
  of the same detections and probabilities equal;
- end to end (a Mask R-CNN of ``test_torch_mask_rcnn.py`` at 96 px over
  images cv2 wrote): detections one-to-one (box IoU >= 0.99, scores within
  1e-4), and each matched detection's pasted mask within 0.5 % of its
  pixels of tpudet's (the two networks' fp32 rounding moves probabilities
  by ~1e-6: a pixel at the threshold may flip); the CLI's report equal to
  the API's (1e-6) and its ``segm.json`` equal to ``results2json``'s.
"""
import json

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet.apis.test import masks_to_segm_results as j_masks_to_segm
from tpudet.apis.test import single_device_test as j_single_device_test
from tpudet.core import mask as jmask
from tpudet.core.nms import NMSResult as JNMSResult
from tpudet.data import CocoDataset as JCocoDataset
from tpudet.evaluation.mean_ap import coco_fast_segm_eval as j_fast_segm
from tpudet.models.builder import build_detector as j_build_detector
from tpudet_torch.apis import inference_detector, init_detector
from tpudet_torch.apis import single_device_test
from tpudet_torch.apis.test import _mask_mode, masks_to_segm_results
from tpudet_torch.config import Config
from tpudet_torch.core import mask as tmask
from tpudet_torch.core.nms import NMSResult
from tpudet_torch.data import CocoDataset
from tpudet_torch.evaluation import (coco_fast_bbox_eval,
                                     coco_fast_segm_eval)
from tpudet_torch.tools import test as cli

from .test_torch_mask_rcnn import (IMG, NUM_CLASSES, _img, jax_init_tree,
                                   mask_rcnn_cfg)
from .test_torch_test_flow import _iou
from . import torch_fixtures  # noqa: F401  (one intra-op thread)

CLASSES = ('cat', 'dog', 'bird')
NORM = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375],
            to_rgb=True)
SIZES = [(96, 96), (80, 96), (96, 72), (60, 90), (96, 88)]
IOU_MIN, SCORE_ATOL, REPORT_ATOL, PIXEL_SHARE = 0.99, 1e-4, 1e-6, 0.005


def _boxes(rng, n, h, w):
    """Boxes inside, across and outside the image, sub-pixel ones, and
    windows of exactly 14 x 14."""
    c = rng.uniform(-0.2, 1.2, (n, 2)) * [w, h]
    wh = np.exp(rng.uniform(np.log(0.3), np.log(1.3 * max(h, w)), (n, 2)))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], 1)
    k = min(n, 3)
    boxes[:k, :2] = np.floor(rng.uniform(0, 20, (k, 2)))
    boxes[:k, 2:] = boxes[:k, :2] + 14
    return boxes.astype(np.float32)


@pytest.mark.parametrize('thr', [0.3, 0.5, 0.7])
def test_paste_matches_tpudets_cv2_paste(thr):
    rng = np.random.RandomState(int(thr * 10))
    for _ in range(8):
        h, w = rng.randint(20, 160, 2)
        probs = rng.rand(30, 28, 28).astype(np.float32)
        boxes = _boxes(rng, 30, h, w)
        ref = jmask.paste_mask_probs(probs, boxes, h, w, thr)
        assert np.array_equal(tmask.paste_mask_probs(probs, boxes, h, w,
                                                     thr), ref)
        got = tmask.paste_masks(torch.from_numpy(probs),
                                torch.from_numpy(boxes), int(h), int(w), thr)
        assert got.shape == ref.shape and got.dtype == torch.bool
        assert np.array_equal(got.numpy(), ref.astype(bool))


def test_paste_goes_through_in_chunks(monkeypatch):
    rng = np.random.RandomState(1)
    probs = rng.rand(9, 28, 28).astype(np.float32)
    boxes = _boxes(rng, 9, 50, 60)
    whole = tmask.paste_masks(torch.from_numpy(probs),
                              torch.from_numpy(boxes), 50, 60)
    monkeypatch.setattr(tmask, 'PASTE_CHUNK_PIXELS', 2 * 50 * 60)
    assert torch.equal(tmask.paste_masks(torch.from_numpy(probs),
                                         torch.from_numpy(boxes), 50, 60),
                       whole)
    empty = tmask.paste_masks(torch.zeros(0, 28, 28), torch.zeros(0, 4),
                              50, 60)
    assert tuple(empty.shape) == (0, 50, 60)


def _masks(rng, n=12, h=23, w=17):
    m = rng.rand(n, h, w) > rng.uniform(0.2, 0.8, (n, 1, 1))
    m[0] = True
    m[1] = False
    m[2, 0, 0], m[3, -1, -1] = True, True
    return m.astype(np.uint8)


def test_rles_match_tpudet():
    rng = np.random.RandomState(2)
    masks = _masks(rng)
    got = tmask.encode_rle_batch(torch.from_numpy(masks.astype(bool)))
    for m, rle in zip(masks, got):
        ref = jmask.encode_rle(m)
        assert tmask.encode_rle(m) == ref and rle == ref
        assert np.array_equal(tmask.decode_rle(rle), jmask.decode_rle(ref))
        assert tmask.rle_area(rle) == jmask.rle_area(ref) == int(m.sum())
    assert tmask.encode_rle_batch(torch.zeros(2, 0, 5)) == \
        [jmask.encode_rle(np.zeros((0, 5), np.uint8))] * 2
    with pytest.raises(ValueError, match='compressed'):
        tmask.decode_rle(dict(size=[2, 2], counts='abc'))


def test_mask_iou_matrix_matches_tpudet():
    rng = np.random.RandomState(3)
    dets = list(_masks(rng, 9))
    gts = list(_masks(rng, 5))
    crowd = np.array([False, True, False, False, True])
    det_rles = [jmask.encode_rle(m) for m in dets]
    for det_in, gt_in in ((dets, gts), (det_rles, gts),
                          (det_rles, [jmask.encode_rle(m) for m in gts])):
        for c in (None, crowd):
            ref = jmask.mask_iou_matrix(det_in, gt_in, c)
            got = tmask.mask_iou_matrix(det_in, gt_in, c)
            assert got.dtype == ref.dtype == np.float32
            assert np.array_equal(got, ref)
    assert tmask.mask_iou_matrix([], gts).shape == (0, 5)


def _segm_inputs(seed, n_img=4, h=60, w=70):
    """Annotations with polygon gts (one crowd), and detections (per image,
    per class (n, 5)) with RLEs: each gt's own bitmap, part of it dropped
    (a hit at some IoU thresholds), and random pastes."""
    rng = np.random.RandomState(seed)
    dets, segms, annos = [], [], []
    for i in range(n_img):
        g = rng.randint(1, 5)
        xy = rng.uniform(0, [w - 20, h - 20], (g, 2))
        wh = rng.uniform(8, 30, (g, 2))
        polys = [[np.stack([x + rng.uniform(0, bw, 6),
                            y + rng.uniform(0, bh, 6)], 1).reshape(-1)
                  .tolist()] for (x, y), (bw, bh) in zip(xy, wh)]
        labels = rng.randint(0, len(CLASSES), g)
        gt_boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
        crowd = np.arange(g) == 0
        annos.append(dict(
            gt_bboxes=gt_boxes, gt_labels=labels,
            gt_attrs=dict(ignore=crowd, iscrowd=crowd,
                          area=(wh[:, 0] * wh[:, 1]).astype(np.float32)),
            gt_masks=polys, img_shape=(h, w)))
        per_cls, per_seg = [], []
        for c in range(len(CLASSES)):
            n = rng.randint(0, 4)
            boxes = _boxes(rng, n, h, w)
            probs = rng.rand(n, 28, 28).astype(np.float32)
            masks = list(jmask.paste_mask_probs(probs, boxes, h, w))
            boxes = list(boxes)
            for k in np.nonzero(labels == c)[0]:
                m = jmask.segmentation_to_bitmap(polys[k], h, w)
                m[:, :int(rng.randint(0, 6))] = 0
                masks.append(m)
                boxes.append(gt_boxes[k])
            scores = rng.rand(len(masks), 1).astype(np.float32)
            per_cls.append(np.concatenate(
                [np.reshape(boxes, (-1, 4)).astype(np.float32), scores], 1))
            per_seg.append([jmask.encode_rle(m) for m in masks])
        dets.append(per_cls)
        segms.append(per_seg)
    return dets, segms, annos


def test_coco_fast_segm_eval_matches_tpudet():
    dets, segms, annos = _segm_inputs(4)
    ref = j_fast_segm(dets, segms, annos, classes=CLASSES)
    got = coco_fast_segm_eval(dets, segms, annos, classes=CLASSES)
    assert list(got) == list(ref) == ['segm_map', 'segm_map50', 'segm_map75',
                                      'segm_s_map', 'segm_m_map',
                                      'segm_l_map']
    for k in ref:
        assert got[k] == ref[k] or (np.isnan(got[k]) and np.isnan(ref[k]))
    assert ref['segm_map50'] > 0


def test_masks_to_segm_results_match_tpudet():
    rng = np.random.RandomState(5)
    b, d = 2, 10
    boxes = np.stack([_boxes(rng, d, 50, 60) for _ in range(b)])
    res = dict(bboxes=boxes, scores=rng.rand(b, d).astype(np.float32),
               labels=rng.randint(0, 3, (b, d)), valid=rng.rand(b, d) > 0.3)
    probs = rng.rand(b, d, 28, 28).astype(np.float32)
    metas = [dict(ori_shape=(50, 60, 3)), dict(ori_shape=(40, 70, 3))]
    ref = j_masks_to_segm(probs, JNMSResult(**res), metas, 3, 0.5)
    got = masks_to_segm_results(
        torch.from_numpy(probs),
        NMSResult(**{k: torch.from_numpy(v) for k, v in res.items()}),
        metas, 3, 0.5)
    assert got == ref


# ---------------------------------------------------------------------------
# end to end


def _cfg():
    return dict(
        model=mask_rcnn_cfg(),
        data=dict(test=dict(pipeline=[
            dict(type='LoadImageFromFile'),
            dict(type='MultiScaleFlipAug', img_scale=(IMG, IMG), flip=False,
                 transforms=[dict(type='Resize', keep_ratio=True),
                             dict(type='RandomFlip'),
                             dict(type='Pad', size_divisor=32),
                             dict(type='Normalize', **NORM)])])))


def _write_set(d, seed):
    """JPEGs of filled polygons on a noise floor and a COCO json whose gts
    are those polygons (one crowd)."""
    rng = np.random.RandomState(seed)
    images, anns = [], []
    for i, (h, w) in enumerate(SIZES):
        img = rng.randint(90, 140, (h, w, 3)).astype(np.uint8)
        for _ in range(rng.randint(2, 5)):
            c = rng.uniform(0.2, 0.8, 2) * [w, h]
            a = np.sort(rng.uniform(0, 2 * np.pi, 7))
            p = c + rng.uniform(6, 25) * np.stack([np.cos(a), np.sin(a)], 1)
            cv2.fillPoly(img, [np.round(p).astype(np.int32)],
                         [int(v) for v in rng.randint(30, 226, 3)])
            x1, y1 = p.min(0)
            x2, y2 = p.max(0)
            anns.append(dict(id=len(anns) + 1, image_id=i + 1,
                             category_id=int(rng.randint(1, 4)),
                             bbox=[x1, y1, x2 - x1, y2 - y1],
                             area=float((x2 - x1) * (y2 - y1)),
                             segmentation=[p.reshape(-1).tolist()],
                             iscrowd=int(len(anns) == 2)))
        assert cv2.imwrite(str(d / f'{i}.jpg'), img)
        images.append(dict(id=i + 1, file_name=f'{i}.jpg', width=w,
                           height=h))
    cats = [dict(id=i + 1, name=n) for i, n in enumerate(CLASSES)]
    (d / 'ann.json').write_text(json.dumps(
        dict(images=images, annotations=anns, categories=cats)))
    return d


@pytest.fixture(scope='module')
def flow(tmp_path_factory):
    """Both packages' Mask R-CNN on one tpudet tree, the set, tpudet's
    ``single_device_test(with_masks=True)`` results."""
    d = _write_set(tmp_path_factory.mktemp('masks'), 0)
    cfg = _cfg()
    jmodel = j_build_detector(cfg['model'])
    variables = jax_init_tree(jmodel, _img(5), 6)
    args = dict(ann_file=str(d / 'ann.json'),
                pipeline=cfg['data']['test']['pipeline'], img_prefix=str(d),
                classes=CLASSES, test_mode=True)
    jds = JCocoDataset(**args)
    ref = j_single_device_test(jmodel, variables, jds, batch_size=2,
                               img_size=IMG, progress=False,
                               with_masks=True)
    det = init_detector(Config(cfg), variables=variables, device='cpu',
                        dtype=torch.float32, classes=CLASSES)
    ds = CocoDataset(**args, device='cpu')
    return d, cfg, variables, det, ds, ref


def _assert_masks_one_to_one(got, ref):
    """Per image and class: detections paired one-to-one (box IoU >=
    IOU_MIN, score within SCORE_ATOL), each pair's masks equal but for
    at most PIXEL_SHARE of the mask's pixels. Returns the pairs seen."""
    (gb, gs), (rb, rs) = got, ref
    pairs = 0
    for g_img, gs_img, r_img, rs_img in zip(gb, gs, rb, rs):
        for g, gm, r, rm in zip(g_img, gs_img, r_img, rs_img):
            assert len(g) == len(r) == len(gm) == len(rm)
            if not len(r):
                continue
            ok = (_iou(r[:, :4], g[:, :4]) >= IOU_MIN) & (
                np.abs(r[:, None, 4] - g[None, :, 4]) <= SCORE_ATOL)
            used = np.zeros(len(g), bool)
            for i in range(len(r)):
                j = np.nonzero(ok[i] & ~used)[0]
                assert len(j), f'detection {r[i]} has no match'
                used[j[0]] = True
                a = jmask.decode_rle(rm[i])
                b = tmask.decode_rle(gm[j[0]])
                assert (a != b).mean() <= PIXEL_SHARE
                pairs += 1
    return pairs


def test_single_device_test_with_masks_matches_tpudet(flow):
    _, _, _, det, ds, ref = flow
    got = single_device_test(det.model, ds, batch_size=2, img_size=IMG,
                             progress=False, with_masks=True)
    assert _assert_masks_one_to_one(got, ref) > 20
    assert _mask_mode(det.model) == 'roi'
    with pytest.raises(ValueError, match='no mask branch'):
        single_device_test(init_detector(
            Config(dict(_cfg(), model=dict(mask_rcnn_cfg(),
                                           type='FasterRCNN',
                                           roi_head=dict(
                                               type='StandardRoIHead',
                                               num_classes=3,
                                               in_channels=32)))),
            device='cpu', dtype=torch.float32).model, ds, with_masks=True)


def test_inference_detector_with_masks_is_the_flows(flow):
    d, _, _, det, ds, _ = flow
    bbox, segm = inference_detector(det, str(d / '1.jpg'), pad_to=IMG,
                                    with_masks=True)
    ref_bbox, ref_segm = single_device_test(
        det.model, ds, batch_size=1, img_size=IMG, progress=False,
        with_masks=True)
    for g, r in zip(bbox, ref_bbox[1]):
        np.testing.assert_array_equal(g, r)
    assert segm == ref_segm[1]
    assert sum(len(s) for s in segm) > 0
    assert inference_detector(det, str(d / '1.jpg'), pad_to=IMG)[0].shape \
        == bbox[0].shape


def test_cli_segm_report_and_json_match_the_api(flow, tmp_path):
    d, cfg, variables, det, ds, _ = flow
    from tpudet_torch.utils.checkpoint import save_variables
    weights = str(tmp_path / 'w.msgpack')
    save_variables(weights, variables, dict(CLASSES=list(CLASSES)))
    cfg_file = tmp_path / 'cfg.py'
    cfg_file.write_text(
        f'model = {cfg["model"]!r}\n'
        f"data = dict(test=dict(type='CocoDataset', ann_file="
        f"{str(d / 'ann.json')!r}, img_prefix={str(d)!r}, "
        f"pipeline={cfg['data']['test']['pipeline']!r}, "
        f'classes={CLASSES!r}))\n')
    report = cli.main([str(cfg_file), weights, '--batch-size', '2',
                       '--img-size', str(IMG), '--eval', 'bbox', 'segm',
                       '--format-out', str(tmp_path / 'cli'),
                       '--device', 'cpu'])
    results, segms = single_device_test(det.model, ds, batch_size=2,
                                        img_size=IMG, progress=False,
                                        with_masks=True)
    annos = [ds.get_ann_info_test(i) for i in range(len(ds))]
    ref = dict(coco_fast_bbox_eval(results, annos, classes=CLASSES),
               **coco_fast_segm_eval(results, segms, annos, classes=CLASSES))
    assert list(report) == list(ref)
    for k, v in ref.items():
        assert abs(report[k] - v) <= REPORT_ATOL or (
            np.isnan(report[k]) and np.isnan(v)), k
    paths = ds.results2json(results, str(tmp_path / 'api'),
                            segm_results=segms)
    assert set(paths) == {'bbox', 'segm'}
    for metric in ('bbox', 'segm'):
        got = json.loads((tmp_path / f'cli.{metric}.json').read_text())
        want = json.loads(open(paths[metric]).read())
        assert got == want and len(got) > 20
    assert all('segmentation' in r for r in got)
