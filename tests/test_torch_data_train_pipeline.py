"""The port's train pipeline (``MosaicPipeline``, ``RandomAffineChain``,
``HueSaturationValueJitter``, ``GtBBoxesFilter``), the whole host train
chain through ``CocoDataset`` and ``DetDataLoader``, against tpudet's, on
the CPU.

Draws: tpudet draws from Python's global generator, seeded here with
``random.seed(s)``; the port from a ``random.Random(s)`` (the dataset's
``rng``, which a loader seeds with ``seed + epoch``). The two give the
same numbers when the draws come in the same order and of the same kinds.

Tolerances (fp32): geometry (mosaic, affine chain, filter, loader
padding) image bytes equal, boxes within 1e-4 px, labels and validity
equal. HSV jitter: equal on at least 99.9 % of the pixels and within 1
uint8 level on all; the port reproduces cv2's 8-bit conversions, so they
are equal here. Images are JPEGs written with cv2 and read by both
packages.
"""
import json
import random

import cv2
import numpy as np
import pytest
import torch

from tpudet.data import CocoDataset as JCocoDataset
from tpudet.data import DetDataLoader as JLoader
from tpudet.data import pipelines as J
from tpudet_torch.data import CocoDataset, DetDataLoader
from tpudet_torch.data import pipelines as P

from . import torch_fixtures  # noqa: F401  (one intra-op thread)

CLASSES = ('cat', 'dog', 'bird')
NORM = dict(mean=[114, 114, 114], std=[255, 255, 255], to_rgb=True)
# (h, w): both aspect groups, several letterbox factors
SIZES = [(96, 128), (128, 96), (80, 80), (200, 150), (64, 128), (150, 90),
         (128, 128), (100, 60), (120, 90), (90, 160)]
AFFINE = dict(pad_to=192, crop=128, scale_limit=0.5, out=64, hflip_p=0.5,
              pad_val=114, min_area=4, min_visibility=0.2)
HSV = dict(hue_ratio=0.015, saturation_ratio=0.7, value_ratio=0.4)
BOX_TOL = 1e-4


class _Draws:
    """Stands for the dataset a transform draws from."""

    def __init__(self, seed):
        self.rng = random.Random(seed)


def _image(h, w, seed):
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    for _ in range(4):
        x0, y0 = rng.randint(0, w - 4), rng.randint(0, h - 4)
        x1, y1 = x0 + rng.randint(2, w - x0), y0 + rng.randint(2, h - y0)
        img[y0:y1, x0:x1] = rng.randint(0, 256, 3)
    return img


def _boxes(h, w, n, seed):
    rng = np.random.RandomState(seed + 100)
    xy = rng.uniform(-0.1, 0.9, (n, 2)) * [w, h]
    wh = rng.uniform(0.02, 0.5, (n, 2)) * [w, h]
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def _np(img):
    return img.cpu().numpy() if isinstance(img, torch.Tensor) else img


def _train_pipeline(backend='turbojpeg', out=64):
    load = [dict(type='LoadImageFromFile', im_decode_backend=backend),
            dict(type='LoadAnnotations', with_bbox=True),
            dict(type='Resize', img_scale=(64, 64), keep_ratio=True)]
    return [dict(type='MosaicPipeline', individual_pipeline=load,
                 pad_val=114),
            dict(type='RandomAffineChain', **dict(AFFINE, out=out)),
            dict(type='HueSaturationValueJitter', **HSV),
            dict(type='GtBBoxesFilter', min_size=2, max_aspect_ratio=20),
            dict(type='Normalize', **NORM)]


@pytest.fixture(scope='module')
def coco_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp('coco_train')
    rng = np.random.RandomState(0)
    images, anns = [], []
    for i, (h, w) in enumerate(SIZES):
        name = f'{i:04d}.jpg'
        assert cv2.imwrite(str(d / name), _image(h, w, i))
        images.append(dict(id=10 + i, file_name=name, width=w, height=h))
        for _ in range(rng.randint(2, 6)):
            bw, bh = rng.uniform(6, w / 2), rng.uniform(6, h / 2)
            x, y = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
            anns.append(dict(id=len(anns) + 1, image_id=10 + i,
                             category_id=int(rng.choice([1, 3, 7])),
                             bbox=[x, y, bw, bh], area=bw * bh, iscrowd=0))
    cats = [dict(id=1, name='cat'), dict(id=3, name='dog'),
            dict(id=7, name='bird')]
    (d / 'ann.json').write_text(json.dumps(dict(
        images=images, annotations=anns, categories=cats)))
    return d


def _pair(coco_dir, pipeline, tpudet_pipeline=None):
    args = dict(ann_file=str(coco_dir / 'ann.json'), img_prefix=str(coco_dir),
                classes=CLASSES)
    return (JCocoDataset(pipeline=tpudet_pipeline or pipeline, **args),
            CocoDataset(pipeline=pipeline, device='cpu', **args))


def assert_same_sample(got, ref, img_level=0.0, equal_share=1.0):
    """Boxes within BOX_TOL, labels and shapes equal; pixels within
    ``img_level`` with at least ``equal_share`` of them equal."""
    np.testing.assert_allclose(got['gt_bboxes'], ref['gt_bboxes'], rtol=0,
                               atol=BOX_TOL)
    assert got['gt_bboxes'].dtype == ref['gt_bboxes'].dtype
    np.testing.assert_array_equal(got['gt_labels'], ref['gt_labels'])
    for k in ('img_shape', 'pad_shape'):
        assert tuple(got[k]) == tuple(ref[k]), k
    g, r = _np(got['img']), ref['img']
    assert g.shape == r.shape and g.dtype == r.dtype
    diff = np.abs(g.astype(np.float64) - r.astype(np.float64))
    assert diff.max() <= img_level * (1 + 1e-6)
    assert (diff == 0).mean() >= equal_share


@pytest.mark.parametrize('seed', [0, 1, 2, 3])
def test_gt_bboxes_filter_matches_tpudet(seed):
    boxes = _boxes(60, 80, 12, seed)
    boxes[0, 2] = boxes[0, 0] + 1.5  # narrower than min_size
    boxes[1, 3] = boxes[1, 1] + 0.05 * (boxes[1, 2] - boxes[1, 0])  # thin
    labels = np.arange(12)
    ref = J.GtBBoxesFilter(2, 20)(dict(gt_bboxes=boxes.copy(),
                                       gt_labels=labels.copy()))
    got = P.GtBBoxesFilter(2, 20)(dict(gt_bboxes=boxes.copy(),
                                       gt_labels=labels.copy()))
    np.testing.assert_array_equal(got['gt_bboxes'], ref['gt_bboxes'])
    np.testing.assert_array_equal(got['gt_labels'], ref['gt_labels'])
    assert 0 < len(ref['gt_labels']) < 12


@pytest.mark.parametrize('idx,seed', [(0, 0), (1, 5), (4, 11), (9, 3)])
def test_mosaic_matches_tpudet(coco_dir, idx, seed):
    load = [dict(type='LoadImageFromFile'),
            dict(type='LoadAnnotations', with_bbox=True),
            dict(type='Resize', img_scale=(64, 64), keep_ratio=True)]
    pipe = [dict(type='MosaicPipeline', individual_pipeline=load,
                 pad_val=114)]
    ref_ds, got_ds = _pair(coco_dir, pipe)
    random.seed(seed)
    ref = ref_ds[idx]
    got_ds.rng = random.Random(seed)
    got = got_ds[idx]
    assert isinstance(got['img'], torch.Tensor) and \
        got['img'].dtype == torch.uint8
    assert_same_sample(got, ref)
    assert got['flip'] is False and got['bbox_fields'] == ['gt_bboxes']
    assert got['img_shape'] == got['pad_shape'] == got['ori_shape']


# out 64 < 128 * (1 - 0.5) never pads: the window branch; out 160 with a
# scale of 1 +/- 0.1 always pads
@pytest.mark.parametrize('out,scale_limit,seed', [
    (64, 0.5, 0), (64, 0.5, 1), (64, 0.5, 7), (100, 0.5, 2), (100, 0.5, 3),
    (160, 0.1, 4)], ids=lambda v: str(v))
def test_random_affine_chain_matches_tpudet(out, scale_limit, seed):
    img = _image(128, 128, seed)
    boxes = _boxes(128, 128, 10, seed)
    labels = np.arange(10)
    kw = dict(AFFINE, out=out, scale_limit=scale_limit)
    random.seed(seed)
    ref = J.RandomAffineChain(**kw)(dict(img=img, gt_bboxes=boxes.copy(),
                                         gt_labels=labels))
    got = P.RandomAffineChain(**kw, device='cpu')(dict(
        img=torch.from_numpy(img), gt_bboxes=boxes.copy(), gt_labels=labels,
        dataset=_Draws(seed)))
    assert_same_sample(got, ref)
    assert got['img'].shape == (out, out, 3)


@pytest.mark.parametrize('w', [640, 131, 64])
@pytest.mark.parametrize('seed', [0, 1])
def test_hsv_jitter_matches_tpudet(w, seed):
    img = _image(48, w, seed + w)
    random.seed(seed)
    ref = J.HueSaturationValueJitter(**HSV)(dict(img=img.copy()))
    got = P.HueSaturationValueJitter(**HSV, device='cpu')(dict(
        img=img.copy(), dataset=_Draws(seed)))
    g = _np(got['img'])
    diff = np.abs(g.astype(int) - ref['img'].astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999
    np.testing.assert_array_equal(g, ref['img'])  # equal here


def test_bgr_to_hsv_is_cv2_on_every_pixel():
    px = np.stack(np.meshgrid(*[np.arange(256)] * 3, indexing='ij'),
                  -1).reshape(4096, 4096, 3).astype(np.uint8)
    np.testing.assert_array_equal(P.bgr_to_hsv(torch.from_numpy(px)).numpy(),
                                  cv2.cvtColor(px, cv2.COLOR_BGR2HSV))


@pytest.mark.parametrize('row', [640, 16], ids=['vector_loop', 'scalar_loop'])
def test_hsv_to_bgr_is_cv2_on_every_pixel(row):
    px = np.stack(np.meshgrid(np.arange(180), np.arange(256), np.arange(256),
                              indexing='ij'), -1).reshape(-1, 3)
    px = px[:len(px) // row * row].reshape(-1, row, 3).astype(np.uint8)
    np.testing.assert_array_equal(P.hsv_to_bgr(torch.from_numpy(px)).numpy(),
                                  cv2.cvtColor(px, cv2.COLOR_HSV2BGR))


@pytest.mark.parametrize('window', [(0, 0, 64, 64), (17, 5, 40, 70)])
def test_imresize_window_is_the_same_pixels(window):
    img = torch.from_numpy(_image(90, 120, 3))
    full = P.imresize_linear(img, 150, 111)
    x, y, w, h = window
    got = P.imresize_linear(img, 150, 111, window=window)
    torch.testing.assert_close(got, full[y:y + h, x:x + w], rtol=0, atol=0)


@pytest.mark.parametrize('idx', [0, 2, 5, 8])
def test_host_train_chain_matches_tpudet(coco_dir, idx):
    ref_ds, got_ds = _pair(coco_dir, _train_pipeline(),
                           _train_pipeline(backend='cv2'))
    random.seed(idx)
    ref = ref_ds[idx]
    got_ds.set_rng_seed(idx)
    got = got_ds[idx]
    assert_same_sample(got, ref, img_level=1 / 255, equal_share=0.999)
    assert got['img'].dtype == torch.float32 and got['img'].shape == (64, 64,
                                                                      3)


def test_loader_batches_of_the_host_chain_match_tpudet(coco_dir):
    """Two epochs of batches: the port's loader seeds the dataset's
    generator with seed + epoch; tpudet's draws from the global one,
    seeded alike here."""
    ref_ds, got_ds = _pair(coco_dir, _train_pipeline(),
                           _train_pipeline(backend='cv2'))
    kw = dict(batch_size=3, max_gts=6, img_size=64, seed=4)
    ref_l, got_l = JLoader(ref_ds, **kw), DetDataLoader(got_ds, **kw)
    for epoch in (0, 1):
        ref_l.set_epoch(epoch)
        got_l.set_epoch(epoch)
        random.seed(kw['seed'] + epoch)
        ref_b = list(ref_l)
        got_b = list(got_l)
        assert len(got_b) == len(ref_b) == len(SIZES) // 3
        for g, r in zip(got_b, ref_b):
            for k in ('gt_labels', 'gt_valid', 'scale_factor'):
                np.testing.assert_array_equal(g[k], r[k])
            np.testing.assert_allclose(g['gt_bboxes'], r['gt_bboxes'],
                                       rtol=0, atol=BOX_TOL)
            diff = np.abs(_np(g['img']) - r['img'])
            assert diff.max() <= (1 + 1e-6) / 255 and \
                (diff == 0).mean() >= 0.999
            assert [m['_idx'] for m in g['img_metas']] == \
                [m['_idx'] for m in r['img_metas']]
    # the max_gts padding is exercised: some image has more gts than fit
    assert max(int(b['gt_valid'].sum(1).max()) for b in got_b) == 6


def test_a_pass_draws_the_same_whenever_it_runs(coco_dir):
    _, ds = _pair(coco_dir, _train_pipeline())
    loader = DetDataLoader(ds, batch_size=5, max_gts=12, img_size=64)
    loader.set_epoch(3)
    first = [b['gt_bboxes'] for b in loader]
    ds.rng.random()  # whatever was drawn in between
    again = [b['gt_bboxes'] for b in loader]
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)


def test_turbojpeg_backend_reads_the_bytes_with_cv2(tmp_path):
    img = _image(75, 101, 6)
    assert cv2.imwrite(str(tmp_path / 'a.jpg'), img)
    results = dict(img_info=dict(filename='a.jpg'),
                   img_prefix=str(tmp_path))
    ref = J.LoadImageFromFile()(dict(results))
    got = P.LoadImageFromFile(im_decode_backend='turbojpeg',
                              device='cpu')(dict(results))
    np.testing.assert_array_equal(got['img'], ref['img'])
    with pytest.raises(FileNotFoundError):
        P.LoadImageFromFile(im_decode_backend='turbojpeg', device='cpu')(dict(
            img_info=dict(filename='none.jpg'), img_prefix=str(tmp_path)))
