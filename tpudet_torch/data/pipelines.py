"""Test-time image pipeline: counterpart of ``tpudet/data/pipelines.py``
(``Compose``, ``LoadImageFromFile``, ``LoadAnnotations``, ``rescale_size``,
``Resize``, ``RandomFlip``, ``Pad``, ``Normalize``, ``MultiScaleFlipAug``).

A transform maps a ``results`` dict to a dict, with tpudet's keys: ``img``,
``gt_bboxes`` (N, 4 xyxy float32 numpy), ``gt_labels``, ``img_shape``,
``ori_shape``, ``pad_shape``, ``scale_factor`` (float32 numpy).

The image ops (``Resize``, ``Pad``, ``Normalize``) are torch ops on the
transform's ``device``, ``cuda`` unless the caller asks for the CPU; the
first of them moves the host image there. The image is an (H, W, 3) BGR
uint8 tensor until ``Normalize``, float32 RGB after it. Boxes, labels and
shapes stay on the host. Files are read by cv2 on the host, imported only
when a file is read.

``Resize`` reproduces ``cv2.resize(..., INTER_LINEAR)`` on uint8 images
bit for bit, in integer tensor ops (``imresize_linear``).

The train-only transforms (Mosaic, HSV jitter, the affine chain, the box
filter, Corrupt, InstaBoost) come with the training pipeline.
"""
from __future__ import annotations

import os.path as osp
import random
from typing import Sequence, Tuple, Union

import numpy as np
import torch

from ..registry import PIPELINES, build_from_cfg
from ..utils.device import resolve_device


class Compose:
    """Transforms built from their configs (or given built) and applied in
    order; ``device`` goes to every transform that takes one."""

    def __init__(self, transforms: Sequence,
                 device: Union[str, torch.device] = 'cuda'):
        self.transforms = []
        for t in transforms:
            if isinstance(t, dict):
                cls = t['type'] if not isinstance(t['type'], str) else \
                    PIPELINES.get(t['type'])
                on_device = getattr(cls, 'on_device', False)
                t = build_from_cfg(t, PIPELINES,
                                   dict(device=device) if on_device else None)
            self.transforms.append(t)

    def __call__(self, results):
        for t in self.transforms:
            results = t(results)
            if results is None:
                return None
        return results


def _on(img, device: torch.device) -> torch.Tensor:
    """The image as a tensor on ``device`` (a host array is copied)."""
    if isinstance(img, np.ndarray):
        img = torch.from_numpy(np.ascontiguousarray(img))
    return img.to(device)


@PIPELINES.register_module()
class LoadImageFromFile:
    """File -> (H, W, 3) BGR uint8 numpy array, read by cv2 on the host
    (tpudet's cv2 backend). tpudet's native JPEG backend
    (``im_decode_backend='turbojpeg'``) is host code that the port does not
    carry; decoding on the GPU comes with a later slice."""

    def __init__(self, to_float32=False, im_decode_backend='cv2', **kwargs):
        if im_decode_backend != 'cv2':
            raise NotImplementedError(
                f'im_decode_backend={im_decode_backend!r}: the port reads '
                'files with cv2 only; decoding on the GPU comes with a later '
                'slice')
        self.to_float32 = to_float32

    @staticmethod
    def _read(filename):
        try:
            import cv2
        except ImportError as e:
            raise ImportError(
                'LoadImageFromFile reads files with cv2, which is not '
                'installed; decoding image files without cv2 comes with a '
                'later slice. Pass decoded BGR uint8 arrays instead '
                '(inference_detector takes one).') from e
        return cv2.imread(filename, cv2.IMREAD_COLOR)

    def __call__(self, results):
        img_info = results['img_info']
        prefix = results.get('img_prefix') or ''
        filename = osp.join(prefix, img_info['filename'])
        img = self._read(filename)
        if img is None:
            raise FileNotFoundError(filename)
        if self.to_float32:
            img = img.astype(np.float32)
        results['filename'] = filename
        results['ori_filename'] = img_info['filename']
        results['img'] = img
        results['img_shape'] = img.shape
        results['ori_shape'] = img.shape
        results['pad_shape'] = img.shape
        results['scale_factor'] = np.array([1., 1., 1., 1.], np.float32)
        results['img_fields'] = ['img']
        results['bbox_fields'] = []
        return results


@PIPELINES.register_module()
class LoadAnnotations:
    """ann_info -> gt_bboxes/gt_labels (boxes and labels only; masks come
    with the mask slice)."""

    def __init__(self, with_bbox=True, with_label=True, with_mask=False,
                 **kwargs):
        if with_mask:
            raise NotImplementedError('LoadAnnotations(with_mask=True) '
                                      'comes with the mask slice')
        self.with_bbox = with_bbox
        self.with_label = with_label

    def __call__(self, results):
        ann = results['ann_info']
        if self.with_bbox:
            results['gt_bboxes'] = ann['bboxes'].copy()
            results['bbox_fields'] = results.get('bbox_fields',
                                                 []) + ['gt_bboxes']
        if self.with_label:
            results['gt_labels'] = ann['labels'].copy()
        return results


def rescale_size(h: int, w: int, scale: Tuple[int, int]):
    """mmcv imrescale sizing: fit within (max_long, max_short)."""
    max_long, max_short = max(scale), min(scale)
    factor = min(max_long / max(h, w), max_short / min(h, w))
    return int(w * factor + 0.5), int(h * factor + 0.5)


# cv2's fixed-point bilinear weights: INTER_RESIZE_COEF_BITS = 11
_COEF_SCALE = 2048


def _linear_taps(dst: int, src: int, clamp: bool):
    """cv2's source index and fixed-point weights of each destination
    pixel along one axis (``resize.cpp``, ``resize``'s coefficient loop):
    the source position ``(d + 0.5) * src / dst - 0.5`` in float32, its
    floor, and the two weights ``rint((1 - f) * 2048)``, ``rint(f * 2048)``.
    Along x, cv2 clamps a position outside the image to the edge with
    weight 0 (``clamp``); along y it keeps the weights and clamps the row
    indices."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(
        np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    if clamp:
        f[s < 0] = 0
        s[s < 0] = 0
        f[s >= src - 1] = 0
        s[s >= src - 1] = src - 1
    w1 = np.rint(f * np.float32(_COEF_SCALE)).astype(np.int32)
    w0 = np.rint((np.float32(1) - f) * np.float32(_COEF_SCALE)).astype(
        np.int32)
    return s, w0, w1


def imresize_linear(img: torch.Tensor, new_w: int, new_h: int
                    ) -> torch.Tensor:
    """``cv2.resize(img, (new_w, new_h), interpolation=cv2.INTER_LINEAR)``
    of an (H, W, C) uint8 tensor, bit for bit, on the tensor's device.

    cv2 interpolates uint8 images in fixed point: 11-bit weights, a
    horizontal pass into int32, then a vertical pass that drops 4 bits of
    each row and keeps the high 16 bits of each product (``v_mul_hi``)
    before a rounding shift by 2 (``VResizeLinearVec_32s8u``). An exact 2x
    shrink, which cv2 sends to INTER_AREA, gives the same numbers this
    way. Bilinear interpolation in float32 rounds differently: 1 level
    apart on about 11 % of the pixels of a noisy image."""
    if img.dtype != torch.uint8:
        raise TypeError(f'imresize_linear takes uint8 images, not '
                        f'{img.dtype}')
    h, w = img.shape[:2]
    if (new_h, new_w) == (h, w):
        return img.clone()
    dev = img.device
    sx, a0, a1 = _linear_taps(new_w, w, clamp=True)
    sy, b0, b1 = _linear_taps(new_h, h, clamp=False)
    x0 = torch.from_numpy(sx).to(dev)
    x1 = torch.from_numpy(np.minimum(sx + 1, w - 1)).to(dev)
    a0 = torch.from_numpy(a0).to(dev)[None, :, None]
    a1 = torch.from_numpy(a1).to(dev)[None, :, None]
    y0 = torch.from_numpy(np.clip(sy, 0, h - 1)).to(dev)
    y1 = torch.from_numpy(np.clip(sy + 1, 0, h - 1)).to(dev)
    b0 = torch.from_numpy(b0).to(dev)[:, None, None]
    b1 = torch.from_numpy(b1).to(dev)[:, None, None]
    px = img.to(torch.int32)
    rows = px[:, x0] * a0 + px[:, x1] * a1  # (H, new_w, C), exact
    out = ((((rows[y0] >> 4) * b0) >> 16) + (((rows[y1] >> 4) * b1) >> 16)
           + 2) >> 2
    return out.clamp_(0, 255).to(torch.uint8)


@PIPELINES.register_module()
class Resize:
    """keep_ratio letterbox resize (mmcv.imrescale + recorded (w, h, w, h)
    scale_factor) on ``device``. A list of (long, short) scales picks one
    per sample (``multiscale_mode='value'``) or samples each edge between
    two (``'range'``), as tpudet does."""

    on_device = True

    def __init__(self, img_scale=None, keep_ratio=True, backend='cv2',
                 multiscale_mode='range', device='cuda'):
        if (isinstance(img_scale, (list, tuple)) and img_scale
                and isinstance(img_scale[0], (list, tuple))):
            self.img_scale = [tuple(s) for s in img_scale]
        elif img_scale is not None:
            if not isinstance(img_scale, (list, tuple)):
                img_scale = (img_scale, img_scale)
            self.img_scale = tuple(img_scale)
        else:
            self.img_scale = None
        assert multiscale_mode in ('value', 'range')
        self.multiscale_mode = multiscale_mode
        self.keep_ratio = keep_ratio
        self.device = resolve_device(device)

    def _pick_scale(self):
        if not isinstance(self.img_scale, list):
            return self.img_scale
        if self.multiscale_mode == 'value' or len(self.img_scale) != 2:
            return random.choice(self.img_scale)
        (l0, s0), (l1, s1) = self.img_scale
        return (random.randint(min(l0, l1), max(l0, l1)),
                random.randint(min(s0, s1), max(s0, s1)))

    def __call__(self, results):
        scale = results.get('scale', None)
        if scale is None:
            scale = self._pick_scale()
        img = _on(results['img'], self.device)
        h, w = img.shape[:2]
        if self.keep_ratio:
            new_w, new_h = rescale_size(h, w, scale)
        else:
            new_w, new_h = scale
        resized = imresize_linear(img, new_w, new_h)
        w_scale = new_w / w
        h_scale = new_h / h
        results['img'] = resized
        results['img_shape'] = tuple(resized.shape)
        results['pad_shape'] = tuple(resized.shape)
        results['scale_factor'] = np.array(
            [w_scale, h_scale, w_scale, h_scale], np.float32)
        for key in results.get('bbox_fields', []):
            bboxes = results[key] * results['scale_factor']
            bboxes[:, 0::2] = np.clip(bboxes[:, 0::2], 0, new_w)
            bboxes[:, 1::2] = np.clip(bboxes[:, 1::2], 0, new_h)
            results[key] = bboxes
        return results


@PIPELINES.register_module()
class RandomFlip:
    """Horizontal flip with probability ``flip_ratio``; ``None`` never
    flips, whatever ``MultiScaleFlipAug`` set."""

    def __init__(self, flip_ratio=None, direction='horizontal'):
        self.flip_ratio = flip_ratio
        self.direction = direction

    def __call__(self, results):
        flip = (self.flip_ratio is not None
                and random.random() < self.flip_ratio)
        results['flip'] = flip
        results['flip_direction'] = self.direction if flip else None
        if flip:
            results['img'] = torch.as_tensor(results['img']).flip(1)
            h, w = results['img'].shape[:2]
            for key in results.get('bbox_fields', []):
                b = results[key].copy()
                b[:, 0] = w - results[key][:, 2]
                b[:, 2] = w - results[key][:, 0]
                results[key] = b
        return results


@PIPELINES.register_module()
class Pad:
    """Pad to a fixed size or a size divisor with ``pad_val``, on
    ``device``."""

    on_device = True

    def __init__(self, size=None, size_divisor=None, pad_val=0,
                 device='cuda'):
        self.size = size
        self.size_divisor = size_divisor
        self.pad_val = pad_val
        self.device = resolve_device(device)

    def __call__(self, results):
        img = _on(results['img'], self.device)
        h, w = img.shape[:2]
        if self.size is not None:
            th, tw = self.size
        else:
            d = self.size_divisor
            th = -(-h // d) * d
            tw = -(-w // d) * d
        padded = img.new_full((th, tw) + tuple(img.shape[2:]), self.pad_val)
        padded[:h, :w] = img
        results['img'] = padded
        results['pad_shape'] = tuple(padded.shape)
        results['pad_fixed_size'] = self.size
        results['pad_size_divisor'] = self.size_divisor
        return results


@PIPELINES.register_module()
class Normalize:
    """(img[, BGR->RGB] - mean) / std in float32, on ``device``."""

    on_device = True

    def __init__(self, mean, std, to_rgb=True, device='cuda'):
        self.mean = np.array(mean, np.float32)
        self.std = np.array(std, np.float32)
        self.to_rgb = to_rgb
        self.device = resolve_device(device)
        self._mean = torch.from_numpy(self.mean).to(self.device)
        self._std = torch.from_numpy(self.std).to(self.device)

    def __call__(self, results):
        img = _on(results['img'], self.device).float()
        if self.to_rgb:
            img = img.flip(-1)
        results['img'] = (img - self._mean) / self._std
        results['img_norm_cfg'] = dict(mean=self.mean, std=self.std,
                                       to_rgb=self.to_rgb)
        return results


@PIPELINES.register_module()
class MultiScaleFlipAug:
    """Test-time wrapper; the YOLO configs use one (640, 640) scale and no
    flip, for which it returns the plain dict."""

    on_device = True

    def __init__(self, transforms, img_scale, flip=False,
                 flip_direction='horizontal', device='cuda'):
        self.transforms = Compose(transforms, device=device)
        self.img_scale = img_scale if isinstance(img_scale,
                                                 list) else [img_scale]
        self.flip = flip

    def __call__(self, results):
        aug_results = []
        flips = [False, True] if self.flip else [False]
        for scale in self.img_scale:
            for f in flips:
                r = dict(results)
                r['scale'] = tuple(scale)
                r['flip'] = f
                aug_results.append(self.transforms(r))
        return aug_results[0] if len(aug_results) == 1 else aug_results
