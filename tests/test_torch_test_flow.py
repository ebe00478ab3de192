"""The evaluation flow of the port against tpudet's, on the CPU in fp32:
``inference_detector`` and ``single_device_test`` over images that cv2
wrote to files and both packages read back, then the fast-bbox report.

The detector is YOLOv4 at the v4s scale with a narrow neck (64 channels),
3 classes, the flagship's lane-budgeted NMS (``anchor_pre=256``: at 128
px there are 1,008 anchors), 128 px test scale, its weights one tpudet
variables tree drawn from a numpy seed for both packages (pred convs wide
enough that scores clear ``score_thr``).

- Images that need no resize (longest side 128): detections one-to-one
  per image and class, box IoU >= 0.99, scores within 1e-4; the fast-bbox
  report of each package's results within 1e-6.
- Images that need a resize: tpudet's preprocessed batch, fed to both
  detectors, gives detections one-to-one at the same tolerances.
"""
import json

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet.apis.inference import Detector as JDetector
from tpudet.apis.inference import inference_detector as j_inference_detector
from tpudet.apis.test import single_device_test as j_single_device_test
from tpudet.config import Config as JConfig
from tpudet.data import CocoDataset as JCocoDataset
from tpudet.data import DetDataLoader as JLoader
from tpudet.evaluation import coco_fast_bbox_eval as j_fast_bbox
from tpudet.models.builder import build_detector as j_build_detector
from tpudet_torch.apis import (inference_detector, init_detector,
                               nms_result_to_per_class, single_device_test)
from tpudet_torch.config import Config
from tpudet_torch.core.nms import NMSResult
from tpudet_torch.data import CocoDataset, DetDataLoader
from tpudet_torch.evaluation import coco_fast_bbox_eval

from . import torch_fixtures  # noqa: F401  (one intra-op thread)

IMG = 128
CLASSES = ('cat', 'dog', 'bird')
NORM = dict(mean=[114, 114, 114], std=[255, 255, 255], to_rgb=True)
# longest side 128: the 128 letterbox leaves them as they are
NO_RESIZE = [(128, 128), (96, 128), (128, 64), (100, 128), (128, 120)]
RESIZE = [(200, 150), (64, 90), (300, 300), (150, 260)]
IOU_MIN, SCORE_ATOL, REPORT_ATOL = 0.99, 1e-4, 1e-6


def _cfg():
    return dict(
        model=dict(
            type='SingleStageDetector',
            backbone=dict(type='DarknetCSP', scale='v4s5p',
                          out_indices=[3, 4, 5]),
            neck=dict(type='YOLOV4Neck', in_channels=[128, 256, 256],
                      out_channels=[64, 64, 64], csp_repetition=1),
            bbox_head=dict(type='YOLOCSPHead', num_classes=len(CLASSES),
                           in_channels=[64, 64, 64]),
            test_cfg=dict(anchor_pre=256, nms_pre=-1, lane_pre=4,
                          class_pre=256, score_thr=0.001,
                          nms=dict(type='nms', iou_threshold=0.65),
                          max_per_img=100)),
        data=dict(test=dict(pipeline=[
            dict(type='LoadImageFromFile'),
            dict(type='MultiScaleFlipAug', img_scale=(IMG, IMG), flip=False,
                 transforms=[dict(type='Resize', keep_ratio=True),
                             dict(type='RandomFlip'),
                             dict(type='Pad', size_divisor=32),
                             dict(type='Normalize', **NORM)])])))


def _variables(jmodel, seed=0):
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, IMG, IMG, 3)))
    rng = np.random.RandomState(seed)

    def draw(path, s):
        keys = [p.key for p in path]
        shape, name = s.shape, keys[-1]
        if name == 'kernel':
            fan_in = int(np.prod(shape[:-1]))
            std = 3.0 if keys[2].startswith('conv_pred') else 1.0
            return (rng.randn(*shape) * std / np.sqrt(fan_in)).astype(
                np.float32)
        if name == 'scale':
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if name == 'var':
            return rng.uniform(0.5, 2.0, shape).astype(np.float32)
        return (rng.randn(*shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _write_set(d, sizes, seed):
    """JPEGs (textured rectangles on a noise floor) and a COCO json with
    2-4 gts an image, one of them crowd."""
    rng = np.random.RandomState(seed)
    images, anns = [], []
    for i, (h, w) in enumerate(sizes):
        img = rng.randint(90, 140, (h, w, 3)).astype(np.uint8)
        for _ in range(rng.randint(2, 5)):
            bw, bh = rng.randint(8, w // 2), rng.randint(8, h // 2)
            x, y = rng.randint(0, w - bw), rng.randint(0, h - bh)
            # textured, not flat: a flat patch gives equal scores at many
            # anchors, and the NMS then breaks ties on the last bit
            img[y:y + bh, x:x + bw] = np.clip(
                rng.randint(30, 226, 3) + rng.randint(-30, 31, (bh, bw, 3)),
                0, 255)
            anns.append(dict(id=len(anns) + 1, image_id=i + 1,
                             category_id=int(rng.randint(1, 4)),
                             bbox=[x, y, bw, bh], area=float(bw * bh),
                             iscrowd=int(len(anns) == 2)))
        assert cv2.imwrite(str(d / f'{i}.jpg'), img)
        images.append(dict(id=i + 1, file_name=f'{i}.jpg', width=w,
                           height=h))
    cats = [dict(id=i + 1, name=n) for i, n in enumerate(CLASSES)]
    (d / 'ann.json').write_text(json.dumps(
        dict(images=images, annotations=anns, categories=cats)))
    return d


@pytest.fixture(scope='module')
def pair():
    cfg = _cfg()
    jmodel = j_build_detector(cfg['model'])
    variables = _variables(jmodel)
    jdet = JDetector(jmodel, variables, JConfig(cfg), classes=CLASSES)
    det = init_detector(Config(cfg), variables=variables, device='cpu',
                        dtype=torch.float32, classes=CLASSES)
    return jdet, det


@pytest.fixture(scope='module')
def no_resize_set(tmp_path_factory):
    return _write_set(tmp_path_factory.mktemp('no_resize'), NO_RESIZE, 0)


@pytest.fixture(scope='module')
def resize_set(tmp_path_factory):
    return _write_set(tmp_path_factory.mktemp('resize'), RESIZE, 1)


def _datasets(d):
    args = dict(ann_file=str(d / 'ann.json'),
                pipeline=_cfg()['data']['test']['pipeline'],
                img_prefix=str(d), classes=CLASSES, test_mode=True)
    return JCocoDataset(**args), CocoDataset(**args, device='cpu')


def _iou(a, b):
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(rb - lt, 0, None), axis=-1)
    area = lambda x: np.prod(x[:, 2:] - x[:, :2], axis=-1)  # noqa: E731
    return inter / (area(a)[:, None] + area(b)[None, :] - inter)


def assert_per_class_one_to_one(got, ref):
    """Per class: the (n, 5) detections pair up one-to-one, box IoU >=
    IOU_MIN and scores within SCORE_ATOL. Returns the detections seen."""
    assert len(got) == len(ref)
    n = 0
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == np.float32
        if not len(r):
            continue
        ok = (_iou(r[:, :4], g[:, :4]) >= IOU_MIN) & (
            np.abs(r[:, None, 4] - g[None, :, 4]) <= SCORE_ATOL)
        used = np.zeros(len(g), bool)
        for i in range(len(r)):
            cand = np.nonzero(ok[i] & ~used)[0]
            assert len(cand), f'detection {r[i]} has no match'
            used[cand[0]] = True
        n += len(r)
    return n


def _nms_np(res):
    return {k: np.array(v) for k, v in res._asdict().items()}


def assert_nms_one_to_one(got, ref):
    n = 0
    for g, r in zip(nms_result_to_per_class(got, len(CLASSES)),
                    nms_result_to_per_class(
                        NMSResult(**{k: torch.as_tensor(v) for k, v in
                                     _nms_np(ref).items()}), len(CLASSES))):
        n += assert_per_class_one_to_one(g, r)
    return n


def test_inference_detector_on_an_array_matches_tpudet(pair, no_resize_set):
    jdet, det = pair
    for i in range(len(NO_RESIZE)):
        img = cv2.imread(str(no_resize_set / f'{i}.jpg'))
        ref = j_inference_detector(jdet, img, pad_to=IMG)
        got = inference_detector(det, img, pad_to=IMG)
        assert assert_per_class_one_to_one(got, ref) > 5


def test_inference_detector_on_a_file_matches_tpudet(pair, resize_set):
    jdet, det = pair
    path = str(resize_set / '0.jpg')
    ref = j_inference_detector(jdet, path, pad_to=IMG)
    got = inference_detector(det, path, pad_to=IMG)
    assert assert_per_class_one_to_one(got, ref) > 5


def test_single_device_test_matches_tpudet(pair, no_resize_set):
    jdet, det = pair
    jds, ds = _datasets(no_resize_set)
    ref = j_single_device_test(jdet.model, jdet.variables, jds,
                               batch_size=2, img_size=IMG, progress=False,
                               process_index=0, process_count=1)
    got = single_device_test(det.model, ds, batch_size=2, img_size=IMG,
                             progress=False)
    assert len(got) == len(ref) == len(NO_RESIZE)
    assert sum(assert_per_class_one_to_one(g, r)
               for g, r in zip(got, ref)) > 50
    annos = [ds.get_ann_info_test(i) for i in range(len(ds))]
    ref_report = j_fast_bbox(ref, [jds.get_ann_info_test(i)
                                   for i in range(len(jds))],
                             classes=CLASSES)
    got_report = coco_fast_bbox_eval(got, annos, classes=CLASSES)
    assert list(got_report) == list(ref_report)
    for k, v in ref_report.items():
        assert np.isnan(v) and np.isnan(got_report[k]) or \
            abs(got_report[k] - v) <= REPORT_ATOL, k


def test_resized_batch_gives_the_same_detections(pair, resize_set):
    """tpudet's preprocessed batch (its pipeline resized every image),
    fed to both detectors; the port's own batch of the same images agrees
    with it within 1 uint8 level."""
    jdet, det = pair
    jds, ds = _datasets(resize_set)
    kw = dict(batch_size=len(RESIZE), max_gts=1, img_size=IMG,
              shuffle=False, drop_last=False)
    jbatch = next(iter(JLoader(jds, **kw)))
    batch = next(iter(DetDataLoader(ds, **kw)))
    assert not all(m['scale_factor'][0] == 1 for m in jbatch['img_metas'])
    np.testing.assert_array_equal(batch['scale_factor'],
                                  jbatch['scale_factor'])
    assert [m['img_shape'] for m in batch['img_metas']] == \
        [m['img_shape'] for m in jbatch['img_metas']]
    diff = np.abs(batch['img'].numpy() - jbatch['img'])
    assert diff.max() <= (1 + 1e-6) / 255 and (diff == 0).mean() >= 0.99
    ref = jdet(jbatch['img'], jbatch['scale_factor'])
    got = det(jbatch['img'], jbatch['scale_factor'])
    assert assert_nms_one_to_one(got, ref) > 20


def test_get_bboxes_absorbs_img_shape(pair):
    """The eval path passes ``img_shape``; the YOLO head ignores it and
    does not clip, as tpudet's."""
    _, det = pair
    img = np.random.RandomState(2).uniform(-0.45, 0.55,
                                           (2, IMG, IMG, 3)).astype(
                                               np.float32)
    with torch.inference_mode():
        pm = det.model(torch.from_numpy(img))
        plain = det.model.get_bboxes(pm)
        hw = torch.tensor([[64.0, 96.0], [128.0, 32.0]])
        shaped = det.model.get_bboxes(pm, img_shape=(hw[:, 0:1],
                                                     hw[:, 1:2]))
    for a, b in zip(plain, shaped):
        assert torch.equal(a, b)
    assert float(plain.bboxes[plain.valid].max()) > 32


def test_detector_call_takes_rescale(pair):
    _, det = pair
    img = np.random.RandomState(3).uniform(-0.45, 0.55,
                                           (1, IMG, IMG, 3)).astype(
                                               np.float32)
    sf = np.full((1, 4), 2.0, np.float32)
    plain = det(img)
    assert torch.equal(det(img, sf, rescale=False).bboxes, plain.bboxes)
    torch.testing.assert_close(det(img, sf, rescale=True).bboxes,
                               plain.bboxes / 2)


def test_single_device_test_takes_infer_fn(pair, no_resize_set):
    _, det = pair
    _, ds = _datasets(no_resize_set)
    calls = []

    def infer_fn(img, scale_factor, img_hw):
        calls.append((tuple(img.shape), img_hw.tolist()))
        b = img.shape[0]
        boxes = torch.tensor([[1., 2., 30., 40.]]).expand(b, 1, 4)
        return NMSResult(bboxes=boxes, scores=torch.full((b, 1), 0.5),
                         labels=torch.full((b, 1), 2),
                         valid=torch.ones(b, 1, dtype=torch.bool))

    got = single_device_test(det.model, ds, batch_size=2, img_size=IMG,
                             progress=False, infer_fn=infer_fn)
    assert [c[0] for c in calls] == [(2, IMG, IMG, 3)] * 2 + [
        (1, IMG, IMG, 3)]
    assert calls[0][1] == [[128.0, 128.0], [96.0, 128.0]]
    assert len(got) == len(NO_RESIZE)
    for per_cls in got:
        assert [len(a) for a in per_cls] == [0, 0, 1]
        np.testing.assert_array_equal(per_cls[2],
                                      [[1., 2., 30., 40., 0.5]])


def test_nms_result_to_per_class_matches_tpudet():
    from tpudet.apis.inference import nms_result_to_per_class as j_split
    rng = np.random.RandomState(4)
    res = dict(bboxes=rng.uniform(0, 100, (3, 7, 4)).astype(np.float32),
               scores=rng.uniform(0, 1, (3, 7)).astype(np.float32),
               labels=rng.randint(0, 3, (3, 7)).astype(np.int32),
               valid=rng.uniform(size=(3, 7)) < 0.6)
    ref = j_split(type('R', (), res), len(CLASSES))
    got = nms_result_to_per_class(
        NMSResult(**{k: torch.from_numpy(v) for k, v in res.items()}),
        len(CLASSES))
    for g, r in zip(got, ref):
        for a, b in zip(g, r):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
