"""Image pipeline: counterpart of ``tpudet/data/pipelines.py``
(``Compose``, ``LoadImageFromFile``, ``LoadAnnotations``, ``rescale_size``,
``Resize``, ``RandomFlip``, ``Pad``, ``Normalize``, ``MultiScaleFlipAug``,
and the train-only ``MosaicPipeline``, ``RandomAffineChain``,
``HueSaturationValueJitter`` and ``GtBBoxesFilter``; ``InstaBoost``
raises).

A transform maps a ``results`` dict to a dict, with tpudet's keys: ``img``,
``gt_bboxes`` (N, 4 xyxy float32 numpy), ``gt_labels``, ``img_shape``,
``ori_shape``, ``pad_shape``, ``scale_factor`` (float32 numpy), and
``gt_frame_masks`` (N, S, S float32, a tensor on the pipeline's device).

The image ops (``Resize``, ``Pad``, ``Normalize``, the mosaic paste, the
affine chain, the HSV jitter) are torch ops on the transform's ``device``,
``cuda`` unless the caller asks for the CPU; the first of them moves the
host image there. The image is an (H, W, 3) BGR uint8 tensor until
``Normalize``, float32 RGB after it. Boxes, labels and shapes stay on the
host. On a CUDA device JPEG files decode on the card with nvJPEG; other
files, and every file on the CPU, are read by cv2 on the host, imported
only when such a file is read.

``Resize`` and the affine chain's scale step reproduce
``cv2.resize(..., INTER_LINEAR)`` on uint8 images bit for bit, in integer
tensor ops (``imresize_linear``); the HSV jitter reproduces cv2's 8-bit
``COLOR_BGR2HSV`` and ``COLOR_HSV2BGR`` (``bgr_to_hsv``, ``hsv_to_bgr``).

Random transforms draw from the generator of the dataset that made the
``results`` (``results['dataset'].rng``, a ``random.Random`` that the
loader seeds from its seed and epoch), in the order and of the kinds of
tpudet's module-level ``random`` calls; without a dataset, from Python's
global generator, as tpudet.
"""
from __future__ import annotations

import functools
import os.path as osp
import random
import threading
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.mask import gt_frame_masks
from ..registry import PIPELINES, build_from_cfg
from ..utils.device import resolve_device, to_device


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
    return to_device(img, device)


def _rng(results):
    """The generator a random transform draws from: the dataset's, else
    Python's global one (the ``random`` module has the same methods)."""
    return getattr(results.get('dataset'), 'rng', random)


@PIPELINES.register_module()
class LoadImageFromFile:
    """File -> (H, W, 3) BGR uint8 image, on the transform's ``device``.

    On a CUDA device the file's bytes go to ``ops/jpeg.py``'s
    ``decode_image``, whatever ``im_decode_backend`` names: a JPEG decodes
    with nvJPEG straight into a tensor on the card, so that no cv2 is
    needed there, and another format needs cv2. tpudet decodes JPEGs with
    its libjpeg loader under ``'turbojpeg'``/``'native'`` and with cv2
    otherwise (``tpudet/data/pipelines.py:51-90``); nvJPEG's pixels differ
    from libjpeg's by a few levels (PERF.md). The decode runs on a side
    stream of the calling thread, and the thread's current stream waits
    for it by an event: a loader's prefetch thread does not wait for the
    consumer's kernels, and the consumer's reads follow the decode.

    On the CPU the image is read by cv2 on the host as a numpy array:
    ``cv2.imread``, or ``cv2.imdecode`` of the file's bytes under
    ``'turbojpeg'``/``'native'`` (tpudet's libjpeg loader gives the same
    pixels for baseline JPEGs). Without cv2 that read raises."""

    on_device = True

    def __init__(self, to_float32=False, im_decode_backend='cv2',
                 device: Union[str, torch.device] = 'cuda', **kwargs):
        if im_decode_backend not in ('cv2', 'turbojpeg', 'native'):
            raise ValueError(f'unknown im_decode_backend '
                             f'{im_decode_backend!r}')
        self.to_float32 = to_float32
        self.from_bytes = im_decode_backend != 'cv2'
        self.device = resolve_device(device)
        self._streams = threading.local()

    def _decode_on_card(self, data: bytes, filename: str) -> torch.Tensor:
        from ..ops import jpeg
        side = getattr(self._streams, 'stream', None)
        if side is None:
            side = self._streams.stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(side):
            img = jpeg.decode_image(data, self.device)
        if img is None:
            raise FileNotFoundError(filename)
        current = torch.cuda.current_stream(self.device)
        current.wait_stream(side)
        img.record_stream(current)
        return img

    @staticmethod
    def _cv2():
        try:
            import cv2
        except ImportError as e:
            raise ImportError(
                'LoadImageFromFile reads every file on the CPU with cv2, '
                'which is not installed. Decode '
                'JPEGs on a CUDA device, or pass decoded BGR uint8 arrays '
                '(inference_detector takes one).') from e
        return cv2

    def _read_bytes(self, filename):
        try:
            with open(filename, 'rb') as f:
                return f.read()
        except OSError:
            raise FileNotFoundError(filename)

    def _read(self, filename):
        if self.device.type == 'cuda':
            return self._decode_on_card(self._read_bytes(filename), filename)
        cv2 = self._cv2()
        if self.from_bytes:
            return cv2.imdecode(np.frombuffer(self._read_bytes(filename),
                                              np.uint8), cv2.IMREAD_COLOR)
        return cv2.imread(filename, cv2.IMREAD_COLOR)

    def __call__(self, results):
        img_info = results['img_info']
        prefix = results.get('img_prefix') or ''
        filename = osp.join(prefix, img_info['filename'])
        img = self._read(filename)
        if img is None:
            raise FileNotFoundError(filename)
        if self.to_float32:
            img = img.float() if isinstance(img, torch.Tensor) else \
                img.astype(np.float32)
        shape = tuple(img.shape)
        results['filename'] = filename
        results['ori_filename'] = img_info['filename']
        results['img'] = img
        results['img_shape'] = shape
        results['ori_shape'] = shape
        results['pad_shape'] = shape
        results['scale_factor'] = np.array([1., 1., 1., 1.], np.float32)
        results['img_fields'] = ['img']
        results['bbox_fields'] = []
        return results


@PIPELINES.register_module()
class LoadAnnotations:
    """ann_info -> gt_bboxes/gt_labels (host numpy), and with ``with_mask``
    each gt's polygons rasterized in its own box frame at
    ``mask_frame_size`` (``tpudet/data/pipelines.py:104-152``): a (G, S, S)
    float32 ``gt_frame_masks`` tensor on ``device``, the fill equal to
    ``cv2.fillPoly`` (``core/mask.py``); a gt without polygons (missing or
    an RLE) gets a full-box mask. Transforms that move boxes leave the
    frame masks as they are; flips mirror them and filters drop them with
    their boxes."""

    on_device = True

    def __init__(self, with_bbox=True, with_label=True, with_mask=False,
                 mask_frame_size=28, device='cuda', **kwargs):
        self.with_bbox = with_bbox
        self.with_label = with_label
        self.with_mask = with_mask
        self.mask_frame_size = mask_frame_size
        self.device = resolve_device(device) if with_mask else None

    def __call__(self, results):
        ann = results['ann_info']
        if self.with_bbox:
            results['gt_bboxes'] = ann['bboxes'].copy()
            results['bbox_fields'] = results.get('bbox_fields',
                                                 []) + ['gt_bboxes']
        if self.with_label:
            results['gt_labels'] = ann['labels'].copy()
        if self.with_mask:
            segs = ann.get('masks') or [None] * len(ann['bboxes'])
            results['gt_frame_masks'] = gt_frame_masks(
                segs, ann['bboxes'], self.mask_frame_size, self.device)
        return results


def rescale_size(h: int, w: int, scale: Tuple[int, int]):
    """mmcv imrescale sizing: fit within (max_long, max_short)."""
    max_long, max_short = max(scale), min(scale)
    factor = min(max_long / max(h, w), max_short / min(h, w))
    return int(w * factor + 0.5), int(h * factor + 0.5)


# cv2's fixed-point bilinear weights: INTER_RESIZE_COEF_BITS = 11
_COEF_SCALE = 2048


def _linear_taps(dst: int, src: int, clamp: bool, device: torch.device):
    """cv2's source index and fixed-point weights of each destination
    pixel along one axis (``resize.cpp``, ``resize``'s coefficient loop):
    the source position ``(d + 0.5) * src / dst - 0.5`` in float64 rounded
    to float32, its floor, and the two weights ``rint((1 - f) * 2048)``,
    ``rint(f * 2048)``. Along x, cv2 clamps a position outside the image to
    the edge with weight 0 (``clamp``); along y it keeps the weights and
    clamps the row indices. Made on ``device``, so no host copy waits for
    the stream."""
    scale = 1.0 / (dst / src)
    f = ((torch.arange(dst, dtype=torch.float64, device=device) + 0.5)
         * scale - 0.5).float()
    s = torch.floor(f)
    f = f - s
    if clamp:
        f = torch.where(s < 0, 0., f)
        s = s.clamp_min(0)
        f = torch.where(s >= src - 1, 0., f)
        s = s.clamp_max(src - 1)
    w1 = torch.round(f * _COEF_SCALE).to(torch.int32)
    w0 = torch.round((1. - f) * _COEF_SCALE).to(torch.int32)
    return s.long(), w0, w1


def imresize_linear(img: torch.Tensor, new_w: int, new_h: int,
                    window: Optional[Tuple[int, int, int, int]] = None
                    ) -> torch.Tensor:
    """``cv2.resize(img, (new_w, new_h), interpolation=cv2.INTER_LINEAR)``
    of an (H, W, C) uint8 tensor, bit for bit, on the tensor's device;
    with ``window=(x, y, w, h)`` only that window of the resized image
    (the same pixels, without computing the rest).

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
    wx, wy, ww, wh = window or (0, 0, new_w, new_h)
    if (new_h, new_w) == (h, w):
        return img[wy:wy + wh, wx:wx + ww].clone()
    dev = img.device
    x0, a0, a1 = (t[wx:wx + ww] for t in _linear_taps(new_w, w, True, dev))
    y, b0, b1 = (t[wy:wy + wh] for t in _linear_taps(new_h, h, False, dev))
    x1 = (x0 + 1).clamp_max(w - 1)
    a0, a1 = a0[None, :, None], a1[None, :, None]
    b0, b1 = b0[:, None, None], b1[:, None, None]

    def rows(yi):  # the horizontal pass over source rows yi, exact in int32
        px = img[yi.clamp(0, h - 1)].to(torch.int32)
        return px[:, x0] * a0 + px[:, x1] * a1

    out = ((((rows(y) >> 4) * b0) >> 16) + (((rows(y + 1) >> 4) * b1) >> 16)
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

    def _pick_scale(self, rng):
        if not isinstance(self.img_scale, list):
            return self.img_scale
        if self.multiscale_mode == 'value' or len(self.img_scale) != 2:
            return rng.choice(self.img_scale)
        (l0, s0), (l1, s1) = self.img_scale
        return (rng.randint(min(l0, l1), max(l0, l1)),
                rng.randint(min(s0, s1), max(s0, s1)))

    def __call__(self, results):
        scale = results.get('scale', None)
        if scale is None:
            scale = self._pick_scale(_rng(results))
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
    flips, whatever ``MultiScaleFlipAug`` set. The gt-frame masks are
    mirrored with their boxes."""

    def __init__(self, flip_ratio=None, direction='horizontal'):
        self.flip_ratio = flip_ratio
        self.direction = direction

    def __call__(self, results):
        flip = (self.flip_ratio is not None
                and _rng(results).random() < self.flip_ratio)
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
            if 'gt_frame_masks' in results:
                results['gt_frame_masks'] = results['gt_frame_masks'].flip(2)
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


@PIPELINES.register_module()
class MosaicPipeline:
    """4-tile mosaic (``tpudet/data/pipelines.py:292-341``): run
    ``individual_pipeline`` on the sample and 3 same-aspect-group partners
    (``dataset.batch_rand_others``), paste them around the canvas center
    into a uint8 canvas on ``device``, offset and concat the boxes."""

    on_device = True

    def __init__(self, individual_pipeline, pad_val=0, device='cuda'):
        self.individual_pipeline = Compose(individual_pipeline,
                                           device=device)
        self.pad_val = pad_val
        self.device = resolve_device(device)

    def __call__(self, results):
        dataset = results['dataset']
        mosaic_results = [results]
        for idx in dataset.batch_rand_others(results['_idx'], 3):
            mosaic_results.append(dataset.prepare_input(idx))
        mosaic_results = [self.individual_pipeline(r) for r in mosaic_results]

        shapes = [r['pad_shape'] for r in mosaic_results]
        # canvas half-size: tpudet/data/pipelines.py:311
        cxy = max(shapes[0][0], shapes[1][0], shapes[0][1], shapes[2][1])
        canvas = torch.full((cxy * 2, cxy * 2, shapes[0][2]), self.pad_val,
                            dtype=torch.uint8, device=self.device)
        all_bboxes, all_labels = [], []
        for i, r in enumerate(mosaic_results):
            h, w = r['pad_shape'][:2]
            x1 = cxy - w if i in (0, 2) else cxy  # left column: anchored
            y1 = cxy - h if i in (0, 1) else cxy  # top row: anchored
            canvas[y1:y1 + h, x1:x1 + w] = _on(r['img'], self.device)
            b = r['gt_bboxes'].copy()
            b[:, 0::2] += x1
            b[:, 1::2] += y1
            all_bboxes.append(b)
            all_labels.append(r['gt_labels'])

        out = mosaic_results[0]
        out['img'] = canvas
        out['gt_bboxes'] = np.concatenate(all_bboxes, axis=0)
        out['gt_labels'] = np.concatenate(all_labels, axis=0)
        out['img_shape'] = tuple(canvas.shape)
        out['ori_shape'] = tuple(canvas.shape)
        out['pad_shape'] = tuple(canvas.shape)
        out['flip'] = False
        out['bbox_fields'] = ['gt_bboxes']
        return out


# cv2's 8-bit RGB2HSV_b (color_hsv.simd.hpp): hsv_shift = 12, and the
# tables saturate_cast<int>((255 << 12) / i), saturate_cast<int>((180 << 12)
# / (6 i)), rounded to nearest even
_HSV_SHIFT = 12
_SDIV = np.concatenate([[0], np.rint((255 << _HSV_SHIFT) /
                                     np.arange(1., 256.))]).astype(np.int32)
_HDIV = np.concatenate([[0], np.rint((180 << _HSV_SHIFT) /
                                     (6. * np.arange(1., 256.)))]).astype(
                                         np.int32)
# pixels per step of cv2's vector loop over a row (uint8 lanes of AVX2)
_CV2_HSV_LANES = 32
# HSV2RGB's (b, g, r) picks from (v, p, q, t) per hue sector
_SECTOR = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3],
                    [2, 1, 0]], np.int64)


@functools.lru_cache(maxsize=None)
def _hsv_tables(device: torch.device):
    """cv2's division tables, the sector picks and the float32 constants of
    its HSV conversions, on ``device`` (made once per device)."""
    f32 = dict(inv255=np.float32(1 / 255.), hscale=np.float32(6 / 180.),
               six=np.float32(6), one=np.float32(1), u255=np.float32(255))
    out = {k: torch.tensor(v, dtype=torch.float32) for k, v in f32.items()}
    out.update(sdiv=torch.from_numpy(_SDIV), hdiv=torch.from_numpy(_HDIV),
               sector=torch.from_numpy(_SECTOR),
               x=torch.arange(256, dtype=torch.float64))
    return {k: v.to(device) for k, v in out.items()}


def bgr_to_hsv(img: torch.Tensor) -> torch.Tensor:
    """``cv2.cvtColor(img, cv2.COLOR_BGR2HSV)`` of an (..., 3) uint8
    tensor, bit for bit: integer ops with cv2's fixed-point division
    tables, ties of the max resolved r first, then g, hue wrapped into
    [0, 180). Held against cv2 on all 2^24 inputs."""
    c = _hsv_tables(img.device)
    p = img.to(torch.int32)
    b, g, r = p[..., 0], p[..., 1], p[..., 2]
    v = torch.maximum(torch.maximum(b, g), r)
    diff = v - torch.minimum(torch.minimum(b, g), r)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * c['sdiv'][v.long()] + half) >> _HSV_SHIFT
    h = torch.where(v == r, g - b,
                    torch.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * c['hdiv'][diff.long()] + half) >> _HSV_SHIFT
    h = torch.where(h < 0, h + 180, h)
    return torch.stack([h, s, v], -1).to(torch.uint8)


def hsv_to_bgr(hsv: torch.Tensor) -> torch.Tensor:
    """``cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)`` of an (H, W, 3) uint8
    tensor with hue in [0, 180), bit for bit against OpenCV 5.0 built for
    AVX2: its ``HSV2RGB_b`` runs in float32 on ``s = S/255``, ``v = V/255``,
    forms ``1 - s h`` and ``1 - s (1 - h)`` with one rounding each (a fused
    multiply-add, taken here in float64, which is exact for these float32
    operands, then rounded once) and scales by 255. Its vector loop, 32
    pixels at a time, truncates to uint8; the scalar loop over the last
    ``W mod 32`` pixels of each row rounds to nearest. Held against cv2 on
    all 180 x 256 x 256 inputs, in rows of 640 (vector loop only) and of
    16 (scalar loop only)."""
    c = _hsv_tables(hsv.device)
    x = hsv.to(torch.float32)
    s = x[..., 1] * c['inv255']
    v = x[..., 2] * c['inv255']
    h = torch.fmod(x[..., 0] * c['hscale'], c['six'])
    sector = torch.floor(h)
    h = h - sector
    s64 = s.double()
    tab = torch.stack([
        v,
        v * (c['one'] - s),
        (1. - s64 * h.double()).float() * v,
        (1. - s64 * (c['one'] - h).double()).float() * v], -1)
    bgr = torch.gather(tab, -1, c['sector'][sector.long()])
    bgr = torch.where((s == 0)[..., None], v[..., None], bgr) * c['u255']
    w = hsv.shape[-2]
    tail = torch.arange(w, device=hsv.device) >= w - w % _CV2_HSV_LANES
    bgr = torch.where(tail[:, None], torch.round(bgr), torch.trunc(bgr))
    return bgr.clamp_(0, 255).to(torch.uint8)


@PIPELINES.register_module()
class HueSaturationValueJitter:
    """YOLOv5-style HSV gain jitter through 256-entry LUTs on BGR uint8
    (``tpudet/data/pipelines.py:344-366``): three gains drawn as tpudet
    draws them; the LUTs in float64 as tpudet builds them in numpy
    (``fmod`` equals numpy's ``%`` on these non-negative values, the
    casts truncate), and cv2's 8-bit conversions, all in torch ops on
    ``device``."""

    on_device = True

    def __init__(self, hue_ratio=0.5, saturation_ratio=0.5, value_ratio=0.5,
                 device='cuda'):
        self.h_ratio = hue_ratio
        self.s_ratio = saturation_ratio
        self.v_ratio = value_ratio
        self.device = resolve_device(device)

    def __call__(self, results):
        rng = _rng(results)
        r = np.array([rng.uniform(-1., 1.) for _ in range(3)]) * \
            [self.h_ratio, self.s_ratio, self.v_ratio] + 1
        x = _hsv_tables(self.device)['x']
        luts = [torch.fmod(x * float(r[0]), 180.),
                (x * float(r[1])).clamp(0, 255),
                (x * float(r[2])).clamp(0, 255)]
        hsv = bgr_to_hsv(_on(results['img'], self.device)).long()
        hsv = torch.stack([lut.to(torch.uint8)[hsv[..., c]]
                           for c, lut in enumerate(luts)], -1)
        results['img'] = hsv_to_bgr(hsv)
        return results


def _keep_masks(results, keep: np.ndarray) -> None:
    """Keep the gt-frame masks (a tensor on any device) of the gts that
    ``keep`` (host bool) keeps."""
    if 'gt_frame_masks' in results:
        masks = results['gt_frame_masks']
        results['gt_frame_masks'] = masks[torch.as_tensor(
            keep, dtype=torch.bool).to(masks.device)]


@PIPELINES.register_module()
class GtBBoxesFilter:
    """Drop degenerate boxes after augmentation
    (``tpudet/data/pipelines.py:369-390``), and their gt-frame masks;
    boxes stay host numpy."""

    def __init__(self, min_size=2, max_aspect_ratio=20):
        assert max_aspect_ratio > 1
        self.min_size = min_size
        self.max_aspect_ratio = max_aspect_ratio

    def __call__(self, results):
        bboxes = results['gt_bboxes']
        w = bboxes[:, 2] - bboxes[:, 0]
        h = bboxes[:, 3] - bboxes[:, 1]
        ar = np.maximum(w / (h + 1e-16), h / (w + 1e-16))
        valid = (w > self.min_size) & (h > self.min_size) & \
                (ar < self.max_aspect_ratio)
        results['gt_bboxes'] = bboxes[valid]
        results['gt_labels'] = results['gt_labels'][valid]
        _keep_masks(results, valid)
        return results


@PIPELINES.register_module()
class RandomAffineChain:
    """The YOLO configs' random affine (``tpudet/data/pipelines.py:
    393-491``): center-pad to ``pad_to``, random-crop ``crop``, random
    scale by 1 +/- ``scale_limit``, center-crop ``out``, horizontal flip;
    boxes (host float64) filtered by ``min_area`` and ``min_visibility``
    as albumentations' BboxParams, their gt-frame masks with them.

    The image ops are integer torch ops on ``device`` with tpudet's draws,
    so the result equals tpudet's byte for byte. The scale step resizes
    with ``imresize_linear`` and computes only the window the center crop
    keeps."""

    on_device = True

    def __init__(self, pad_to=1920, crop=1280, scale_limit=0.5, out=640,
                 hflip_p=0.5, pad_val=114, min_area=4, min_visibility=0.2,
                 device='cuda'):
        self.pad_to = pad_to
        self.crop = crop
        self.scale_limit = scale_limit
        self.out = out
        self.hflip_p = hflip_p
        self.pad_val = pad_val
        self.min_area = min_area
        self.min_visibility = min_visibility
        self.device = resolve_device(device)

    def __call__(self, results):
        rng = _rng(results)
        img = _on(results['img'], self.device)
        bboxes = results['gt_bboxes'].astype(np.float64)
        labels = results['gt_labels']
        h, w = img.shape[:2]
        # normalized area before the chain (albu visibility is computed in
        # normalized coords, so pure scaling does not reduce it)
        area0 = ((bboxes[:, 2] - bboxes[:, 0]) *
                 (bboxes[:, 3] - bboxes[:, 1]) / max(h * w, 1))

        # 1) center pad to at least pad_to
        ph, pw = max(self.pad_to, h), max(self.pad_to, w)
        top, left = (ph - h) // 2, (pw - w) // 2
        canvas = img.new_full((ph, pw, img.shape[2]), self.pad_val)
        canvas[top:top + h, left:left + w] = img
        bboxes[:, 0::2] += left
        bboxes[:, 1::2] += top
        img, h, w = canvas, ph, pw

        # 2) random crop
        c = self.crop
        y0 = rng.randint(0, max(h - c, 0))
        x0 = rng.randint(0, max(w - c, 0))
        img = img[y0:y0 + c, x0:x0 + c]
        bboxes[:, 0::2] -= x0
        bboxes[:, 1::2] -= y0
        h = w = c

        # 3) random scale, 4) center crop to out (pad first if smaller)
        f = 1.0 + rng.uniform(-self.scale_limit, self.scale_limit)
        nh, nw = int(h * f), int(w * f)
        bboxes *= [nw / w, nh / h, nw / w, nh / h]
        o = self.out
        if nh < o or nw < o:
            img = imresize_linear(img, nw, nh)
            canvas = img.new_full((max(nh, o), max(nw, o), img.shape[2]),
                                  self.pad_val)
            t = (canvas.shape[0] - nh) // 2
            l = (canvas.shape[1] - nw) // 2  # noqa: E741
            canvas[t:t + nh, l:l + nw] = img
            bboxes[:, 0::2] += l
            bboxes[:, 1::2] += t
            nh, nw = canvas.shape[:2]
            y0, x0 = (nh - o) // 2, (nw - o) // 2
            img = canvas[y0:y0 + o, x0:x0 + o]
        else:
            y0, x0 = (nh - o) // 2, (nw - o) // 2
            img = imresize_linear(img, nw, nh, window=(x0, y0, o, o))
        bboxes[:, 0::2] -= x0
        bboxes[:, 1::2] -= y0

        # 5) horizontal flip
        if rng.random() < self.hflip_p:
            img = img.flip(1)
            x1 = o - bboxes[:, 2].copy()
            x2 = o - bboxes[:, 0].copy()
            bboxes[:, 0], bboxes[:, 2] = x1, x2

        # clip + filter (albu BboxParams: min_area, min_visibility)
        clipped = bboxes.copy()
        clipped[:, 0::2] = np.clip(clipped[:, 0::2], 0, o)
        clipped[:, 1::2] = np.clip(clipped[:, 1::2], 0, o)
        area = ((clipped[:, 2] - clipped[:, 0]) *
                (clipped[:, 3] - clipped[:, 1]))
        visibility = (area / (o * o)) / np.maximum(area0, 1e-12)
        keep = (area >= self.min_area) & (visibility >= self.min_visibility)

        results['img'] = img
        results['gt_bboxes'] = clipped[keep].astype(np.float32)
        results['gt_labels'] = labels[keep]
        _keep_masks(results, keep)
        results['img_shape'] = tuple(img.shape)
        results['pad_shape'] = tuple(img.shape)
        return results


@PIPELINES.register_module()
class InstaBoost:
    """tpudet's instance copy-paste augmentation
    (``tpudet/data/pipelines.py:546-613``) is not ported: building it
    raises."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            'InstaBoost is not ported; it comes with ROADMAP.md\'s "rest of '
            'the zoo" item (Corrupt and InstaBoost)')
