"""The port's test-time pipeline (``tpudet_torch/data/pipelines.py``)
against tpudet's, on the CPU.

Inputs are uint8 BGR images from numpy seeds (noise, with filled
rectangles) at sizes that the 640 letterbox shrinks by a non-integer
factor, shrinks by exactly 2, grows, and leaves alone.

Tolerances: ``img_shape``, ``pad_shape``, ``scale_factor`` and boxes
exactly equal; pixels at most 1 uint8 level apart (1/255 after
``Normalize``) with at least 99 % of them equal. (The port's resize
reproduces cv2's fixed-point arithmetic, so they are equal here.) Files
read by ``LoadImageFromFile``: bit-exact.
"""
import random
import sys

import cv2
import numpy as np
import pytest
import torch

from tpudet.data import pipelines as J
from tpudet_torch.data import pipelines as P

NORM = dict(mean=[114, 114, 114], std=[255, 255, 255], to_rgb=True)
# (h, w): shrink by a non-integer factor, shrink by exactly 2, grow, keep
SIZES = {
    'shrink_480x1000': (480, 1000),
    'shrink_721x1283': (721, 1283),
    'shrink_2x_1280x720': (720, 1280),
    'shrink_2x_1280x1280': (1280, 1280),
    'grow_333x500': (333, 500),
    'grow_37x53': (37, 53),
    'keep_480x640': (480, 640),
    'keep_640x427': (640, 427),
}


def _image(h, w, seed):
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    for _ in range(4):
        x0, y0 = rng.randint(0, w - 4), rng.randint(0, h - 4)
        x1, y1 = x0 + rng.randint(2, w - x0), y0 + rng.randint(2, h - y0)
        img[y0:y1, x0:x1] = rng.randint(0, 256, 3)
    return img


def _boxes(h, w, seed):
    rng = np.random.RandomState(seed + 100)
    xy = rng.uniform(0, [w, h], (5, 2))
    wh = rng.uniform(1, [w, h], (5, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def _results(img, boxes=None):
    r = dict(img=img, img_shape=img.shape, ori_shape=img.shape,
             pad_shape=img.shape, scale_factor=np.ones(4, np.float32),
             img_fields=['img'], bbox_fields=[])
    if boxes is not None:
        r['gt_bboxes'] = boxes
        r['bbox_fields'] = ['gt_bboxes']
    return r


def _np(img):
    return img.numpy() if isinstance(img, torch.Tensor) else img


def assert_pixels_close(got, ref, level):
    """At most ``level`` apart (one uint8 level), >= 99 % equal."""
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    diff = np.abs(got.astype(np.float64) - ref.astype(np.float64))
    assert diff.max() <= level * (1 + 1e-6)
    assert (diff == 0).mean() >= 0.99


def _test_transforms(aug):
    return [dict(type='MultiScaleFlipAug', img_scale=(640, 640), flip=aug,
                 transforms=[dict(type='Resize', keep_ratio=True),
                             dict(type='RandomFlip'),
                             dict(type='Pad', size_divisor=32),
                             dict(type='Normalize', **NORM)])]


@pytest.mark.parametrize('scale', [(640, 640), (1333, 800), (64, 64),
                                   (512, 320)])
def test_rescale_size_matches_tpudet(scale):
    for h in range(1, 1500, 37):
        for w in range(1, 1500, 41):
            assert P.rescale_size(h, w, scale) == J.rescale_size(h, w, scale)


@pytest.mark.parametrize('name', sorted(SIZES))
def test_resize_matches_tpudet(name):
    h, w = SIZES[name]
    img, boxes = _image(h, w, 0), _boxes(h, w, 0)
    ref = J.Resize(img_scale=(640, 640))(_results(img, boxes))
    got = P.Resize(img_scale=(640, 640), device='cpu')(
        _results(img, boxes))
    assert got['img_shape'] == ref['img_shape']
    assert got['pad_shape'] == ref['pad_shape']
    assert got['scale_factor'].dtype == np.float32
    np.testing.assert_array_equal(got['scale_factor'], ref['scale_factor'])
    np.testing.assert_array_equal(got['gt_bboxes'], ref['gt_bboxes'])
    assert_pixels_close(got['img'], ref['img'], 1)


@pytest.mark.parametrize('h,w,new_h,new_w', [
    (480, 640, 398, 531), (333, 500, 456, 685), (720, 1280, 360, 640),
    (481, 641, 480, 640), (37, 53, 447, 640), (5, 7, 3, 2), (1, 1, 4, 3),
    (640, 480, 640, 480)])
def test_imresize_linear_matches_cv2(h, w, new_h, new_w):
    img = np.random.RandomState(h * w).randint(0, 256, (h, w, 3)).astype(
        np.uint8)
    ref = cv2.resize(img, (new_w, new_h), interpolation=cv2.INTER_LINEAR)
    got = P.imresize_linear(torch.from_numpy(img), new_w, new_h)
    assert_pixels_close(got, ref, 1)


def test_imresize_linear_takes_only_uint8():
    with pytest.raises(TypeError, match='uint8'):
        P.imresize_linear(torch.zeros(4, 4, 3), 2, 2)


@pytest.mark.parametrize('pad', [dict(size_divisor=32), dict(size=(96, 128)),
                                 dict(size_divisor=128, pad_val=114)])
def test_pad_matches_tpudet(pad):
    img = _image(70, 90, 1)
    ref = J.Pad(**pad)(_results(img))
    got = P.Pad(**pad, device='cpu')(_results(img))
    assert got['pad_shape'] == ref['pad_shape']
    assert got['pad_fixed_size'] == ref['pad_fixed_size']
    assert got['pad_size_divisor'] == ref['pad_size_divisor']
    np.testing.assert_array_equal(_np(got['img']), ref['img'])


@pytest.mark.parametrize('to_rgb', [True, False])
def test_normalize_matches_tpudet(to_rgb):
    img = _image(40, 56, 2)
    norm = dict(mean=[103.5, 116.25, 123.7], std=[57.4, 57.1, 58.4],
                to_rgb=to_rgb)
    ref = J.Normalize(**norm)(_results(img))
    got = P.Normalize(**norm, device='cpu')(_results(img))
    assert got['img'].dtype == torch.float32
    np.testing.assert_array_equal(_np(got['img']), ref['img'])
    for k in ('mean', 'std'):
        np.testing.assert_array_equal(got['img_norm_cfg'][k],
                                      ref['img_norm_cfg'][k])


@pytest.mark.parametrize('name', sorted(SIZES))
def test_test_pipeline_matches_tpudet(name):
    """MultiScaleFlipAug(Resize, RandomFlip, Pad, Normalize), the YOLO
    configs' test pipeline after its loader."""
    h, w = SIZES[name]
    img = _image(h, w, 3)
    ref = J.Compose(_test_transforms(False))(_results(img))
    got = P.Compose(_test_transforms(False), device='cpu')(_results(img))
    for k in ('img_shape', 'pad_shape', 'ori_shape', 'flip'):
        assert got[k] == ref[k], k
    np.testing.assert_array_equal(got['scale_factor'], ref['scale_factor'])
    assert_pixels_close(got['img'], ref['img'], 1 / 255)


def test_flip_ratio_none_never_flips():
    """``MultiScaleFlipAug(flip=True)`` asks for a flipped copy;
    ``RandomFlip(flip_ratio=None)`` keeps it unflipped, in both
    packages."""
    img = _image(64, 96, 4)
    ref = J.Compose(_test_transforms(True))(_results(img))
    got = P.Compose(_test_transforms(True), device='cpu')(_results(img))
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        assert g['flip'] is False and r['flip'] is False
        np.testing.assert_array_equal(_np(g['img']), r['img'])


def test_random_flip_matches_tpudet():
    img, boxes = _image(50, 70, 5), _boxes(50, 70, 5)
    random.seed(0)
    ref = J.RandomFlip(flip_ratio=1.0)(_results(img, boxes))
    got = P.RandomFlip(flip_ratio=1.0)(
        _results(torch.from_numpy(img), boxes))
    assert got['flip'] and ref['flip']
    assert got['flip_direction'] == ref['flip_direction']
    np.testing.assert_array_equal(_np(got['img']), ref['img'])
    np.testing.assert_array_equal(got['gt_bboxes'], ref['gt_bboxes'])


def _file_pipeline():
    return [dict(type='LoadImageFromFile'),
            dict(type='LoadAnnotations', with_bbox=True)]


def test_load_image_from_file_is_bit_exact(tmp_path):
    img = _image(75, 101, 6)
    path = tmp_path / 'img.jpg'
    assert cv2.imwrite(str(path), img)
    ann = dict(bboxes=_boxes(75, 101, 6), labels=np.arange(5))
    src = dict(img_info=dict(filename='img.jpg'), img_prefix=str(tmp_path),
               ann_info=ann)
    ref = J.Compose(_file_pipeline())(dict(src))
    got = P.Compose(_file_pipeline(), device='cpu')(dict(src))
    assert isinstance(got['img'], np.ndarray)
    np.testing.assert_array_equal(got['img'], ref['img'])
    for k in ('filename', 'ori_filename', 'img_shape', 'ori_shape',
              'pad_shape', 'img_fields', 'bbox_fields'):
        assert got[k] == ref[k], k
    for k in ('scale_factor', 'gt_bboxes', 'gt_labels'):
        np.testing.assert_array_equal(got[k], ref[k])


def test_load_image_without_cv2_says_decoding_comes_later(monkeypatch,
                                                          tmp_path):
    """On the CPU every file is read by cv2; without it the read raises
    and names the ways that need no cv2."""
    monkeypatch.setitem(sys.modules, 'cv2', None)
    load = P.LoadImageFromFile(device='cpu')
    with pytest.raises(ImportError, match='Decode JPEGs on a CUDA device'):
        load(dict(img_info=dict(filename='x.jpg'), img_prefix=str(tmp_path)))


def test_load_image_takes_only_the_cv2_backend():
    """On the CPU every backend decodes with cv2: ``'turbojpeg'`` and
    ``'native'`` read the bytes and ``cv2.imdecode`` them (tpudet's
    fallback); an unknown backend raises."""
    for backend in ('cv2', 'turbojpeg', 'native'):
        P.LoadImageFromFile(im_decode_backend=backend, device='cpu')
    with pytest.raises(ValueError, match='pillow'):
        P.LoadImageFromFile(im_decode_backend='pillow', device='cpu')


def test_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        P.LoadImageFromFile(device='cpu')(dict(
            img_info=dict(filename='none.jpg'), img_prefix=str(tmp_path)))


@pytest.mark.parametrize('transform', ['Resize', 'Pad', 'Normalize'])
def test_image_ops_default_to_cuda_and_raise_without_it(monkeypatch,
                                                        transform):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    args = dict(Resize=dict(img_scale=(64, 64)), Pad=dict(size_divisor=32),
                Normalize=NORM)[transform]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(P, transform)(**args)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.Compose([dict(type=transform, **args)])


def test_compose_gives_the_device_to_nested_transforms():
    pipe = P.Compose(_test_transforms(False), device='cpu')
    inner = pipe.transforms[0].transforms.transforms
    assert [type(t).__name__ for t in inner] == ['Resize', 'RandomFlip',
                                                 'Pad', 'Normalize']
    assert all(t.device == torch.device('cpu') for t in inner
               if hasattr(t, 'device'))
