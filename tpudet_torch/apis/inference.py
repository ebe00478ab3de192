"""Inference API: counterpart of ``tpudet/apis/inference.py``
(``init_detector``, ``Detector``, ``inference_detector``,
``async_inference_detector``, ``nms_result_to_per_class``).

``init_detector`` returns a :class:`Detector`: the built model on its
device with its weights, and the config's test pipeline on the same
device. ``inference_detector`` takes a decoded BGR uint8 image (a numpy
array) or a file path (a JPEG decodes on the card with nvJPEG), and
returns the reference's result format: a list of per-class (n, 5) numpy
arrays.

Entry points run on ``cuda`` unless the caller passes ``device='cpu'``;
with no GPU they raise rather than run on the CPU.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..config import Config
from ..core.nms import NMSResult
from ..data.dataset import COCO_CLASSES
from ..data.pipelines import Compose
from ..models.builder import build_detector
from ..utils.checkpoint import load_variables
from ..utils.device import resolve_device
from ..utils.flax_import import load_flax_variables, random_flax_variables

# the YOLO configs' test pipeline, for a config without ``data``
DEFAULT_TEST_PIPELINE = [
    dict(type='LoadImageFromFile'),
    dict(type='MultiScaleFlipAug', img_scale=(640, 640), flip=False,
         transforms=[
             dict(type='Resize', keep_ratio=True),
             dict(type='RandomFlip'),
             dict(type='Pad', size_divisor=32),
             dict(type='Normalize', mean=[114, 114, 114],
                  std=[255, 255, 255], to_rgb=True),
         ])
]


class Detector:
    """A built detector on its device, in eval mode, with its class names
    and the config's test pipeline (on the same device)."""

    def __init__(self, model, cfg: Optional[Config] = None,
                 classes: Sequence[str] = COCO_CLASSES):
        self.model = model.eval()
        self.cfg = cfg
        self.device = next(model.parameters()).device
        self.CLASSES = tuple(classes)
        test_pipeline = None
        if cfg is not None and 'data' in cfg:
            test_pipeline = cfg['data']['test']['pipeline']
        self.pipeline = Compose(test_pipeline or DEFAULT_TEST_PIPELINE,
                                device=self.device)

    def forward(self, img) -> tuple:
        """Raw pred maps of an image batch (B, H, W, 3)."""
        with torch.inference_mode():
            return self.model(torch.as_tensor(img, device=self.device))

    def __call__(self, img, scale_factor=None, rescale: bool = True
                 ) -> NMSResult:
        """Detections of a normalized image batch (B, H, W, 3), H and W
        multiples of 32. With ``rescale``, ``scale_factor`` (B, 4) maps
        boxes back to the original images."""
        with torch.inference_mode():
            pred_maps = self.model(torch.as_tensor(img, device=self.device))
            return self.model.get_bboxes(
                pred_maps, scale_factors=scale_factor if rescale else None)


def init_detector(config: Union[str, Config, Dict],
                  checkpoint: Optional[str] = None,
                  device: Union[str, torch.device] = 'cuda',
                  dtype: torch.dtype = torch.bfloat16,
                  classes: Sequence[str] = COCO_CLASSES, *,
                  variables: Optional[Dict] = None) -> Detector:
    """Build a detector from a config file, ``Config`` or model dict, put
    it on ``device`` in compute dtype ``dtype`` with its weights from, in
    this order:

    - ``checkpoint``, a ``*.msgpack`` weights file of tpudet's or the
      port's ``save_variables`` (``best_ema.msgpack``, ``latest_ema.msgpack``);
      ``CLASSES`` in its meta replace ``classes``, as in tpudet;
    - ``variables``, a tpudet ``{'params', 'batch_stats'}`` numpy tree;
    - tpudet's init drawn from numpy seed 0.
    """
    if checkpoint is not None and variables is not None:
        raise ValueError('init_detector takes a checkpoint or variables, '
                         'not both')
    device = resolve_device(device)
    if isinstance(config, str):
        config = Config.fromfile(config)
    cfg = config if isinstance(config, Config) else Config(dict(model=config))
    model = build_detector(cfg['model'])
    if checkpoint is not None:
        variables, meta = load_variables(checkpoint)
        classes = meta.get('CLASSES', classes)
    elif variables is None:
        variables = random_flax_variables(model, seed=0)
    load_flax_variables(model, variables)
    model.set_dtype(dtype)
    model.to(device=device, memory_format=torch.channels_last)
    return Detector(model, cfg, classes)


def _prepare_image(detector: Detector, img: Union[str, np.ndarray]):
    """The test pipeline's results for a file path or a decoded BGR uint8
    array (which skips the pipeline's loader stage)."""
    if isinstance(img, str):
        return detector.pipeline(
            dict(img_info=dict(filename=img), img_prefix=None))
    results = dict(
        img=img, img_shape=img.shape, ori_shape=img.shape,
        pad_shape=img.shape,
        scale_factor=np.ones(4, np.float32),
        img_fields=['img'], bbox_fields=[])
    for t in detector.pipeline.transforms[1:]:
        results = t(results)
    return results


def _pad_canvas(image: torch.Tensor, pad_to: Optional[int],
                divisor: int = 32) -> torch.Tensor:
    """Zero-pad to a square static shape: at least ``pad_to``, never
    smaller than the image, rounded up to the pipeline's pad divisor."""
    h, w = image.shape[:2]
    side = max(pad_to or 0, max(h, w))
    side = -(-side // divisor) * divisor
    canvas = image.new_zeros((side, side, 3))
    canvas[:h, :w] = image
    return canvas


def _pipeline_pad_divisor(detector) -> int:
    """The Pad size_divisor of the detector's test pipeline (if any),
    descending into wrappers like MultiScaleFlipAug; 32 without one."""

    def scan(transforms):
        for t in transforms:
            d = getattr(t, 'size_divisor', None)
            if d:
                return int(d)
            inner = getattr(t, 'transforms', None)
            if inner is not None:
                d = scan(getattr(inner, 'transforms', inner))
                if d:
                    return d
        return 0

    return scan(getattr(detector.pipeline, 'transforms', [])) or 32


def _dispatch(detector: Detector, img: Union[str, np.ndarray],
              pad_to: Optional[int]) -> NMSResult:
    """The test pipeline and one detector call on one image."""
    results = _prepare_image(detector, img)
    image = torch.as_tensor(results['img'], device=detector.device).float()
    if pad_to is not None:
        image = _pad_canvas(image, pad_to,
                            divisor=_pipeline_pad_divisor(detector))
    scale_factor = np.asarray(results['scale_factor'],
                              np.float32).reshape(1, 4)
    return detector(image[None], scale_factor, rescale=True)


def inference_detector(detector: Detector,
                       img: Union[str, np.ndarray],
                       pad_to: Optional[int] = 640,
                       with_masks: bool = False,
                       mask_thr: float = 0.5):
    """Single-image inference returning per-class (n, 5) arrays in the
    original image's frame; ``with_masks`` on a detector with a mask
    branch returns the reference's two-tuple ``(bbox_result,
    segm_result)``, the second per-class lists of uncompressed RLE dicts
    (``tpudet/apis/inference.py:167-222``)."""
    if not with_masks:
        res = _dispatch(detector, img, pad_to)
        return nms_result_to_per_class(res, len(detector.CLASSES))[0]
    from .test import _mask_mode, masks_to_segm_results, predict_masks
    model = detector.model
    if _mask_mode(model) is None:
        raise ValueError(f'{type(model).__name__} has no mask branch')
    results = _prepare_image(detector, img)
    image = torch.as_tensor(results['img'], device=detector.device).float()
    if pad_to is not None:
        image = _pad_canvas(image, pad_to,
                            divisor=_pipeline_pad_divisor(detector))
    scale_factor = torch.as_tensor(np.asarray(
        results['scale_factor'], np.float32).reshape(1, 4),
        device=detector.device)
    with torch.inference_mode():
        res, probs = predict_masks(model, image[None], scale_factor)
        ori = results.get('ori_shape') or tuple(image.shape[:2])
        segm = masks_to_segm_results(probs, res, [dict(ori_shape=ori)],
                                     len(detector.CLASSES), mask_thr)[0]
    return nms_result_to_per_class(res, len(detector.CLASSES))[0], segm


async def async_inference_detector(detector: Detector,
                                   img: Union[str, np.ndarray],
                                   pad_to: Optional[int] = 640):
    """:func:`inference_detector` as a coroutine (tpudet's
    ``async_inference_detector``): prepare and dispatch the call, yield
    to other tasks (``await asyncio.sleep(0)``) while the device computes,
    then fetch. The NMS's block walk waits for the device on the host
    inside the call, so the yield comes after it."""
    import asyncio

    res = _dispatch(detector, img, pad_to)
    await asyncio.sleep(0)
    return nms_result_to_per_class(res, len(detector.CLASSES))[0]


def nms_result_to_per_class(res: NMSResult, num_classes: int
                            ) -> List[List[np.ndarray]]:
    """Padded NMSResult -> the reference's bbox2result format (per image,
    per class (n, 5) float32 arrays), on the host."""
    bboxes = res.bboxes.float().cpu().numpy()
    scores = res.scores.float().cpu().numpy()
    labels = res.labels.cpu().numpy()
    valid = res.valid.cpu().numpy()
    out = []
    for i in range(bboxes.shape[0]):
        v = valid[i]
        dets = np.concatenate([bboxes[i][v], scores[i][v][:, None]],
                              axis=-1).astype(np.float32)
        lab = labels[i][v]
        out.append([dets[lab == c] for c in range(num_classes)])
    return out
