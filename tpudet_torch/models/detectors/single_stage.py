"""Single-stage detector: backbone -> neck -> dense head. Port of
``tpudet/models/detectors/single_stage.py`` (``SingleStageDetector``,
``YOLOV4``, ``YOLOV5``, ``YOLOV3``, ``RetinaNet``, ``ATSS``, ``GFL``,
``VFNet``)."""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ...registry import DETECTORS
from ..layers import cast_weights


@DETECTORS.register_module()
class SingleStageDetector(nn.Module):

    default_iou_thr = 0.65  # NMS IoU when the config omits it
    strip_test_keys = ()    # extra test_cfg keys the head must not see

    def __init__(self, backbone: nn.Module, bbox_head: nn.Module,
                 neck: Optional[nn.Module] = None,
                 train_cfg: Optional[Dict] = None,
                 test_cfg: Optional[Dict] = None):
        super().__init__()
        self.backbone = backbone
        self.neck = neck
        self.bbox_head = bbox_head
        self.train_cfg = train_cfg
        self.test_cfg = test_cfg
        self.dtype = torch.float32

    def set_dtype(self, dtype: torch.dtype) -> 'SingleStageDetector':
        """Compute dtype for inference, as tpudet's module ``dtype``: conv
        weights (and the head's biases) are stored in it; BatchNorm keeps
        fp32 parameters and statistics and returns its input's dtype.

        Training keeps fp32 master weights and sets only ``self.dtype``, the
        dtype the image is cast to: every conv then casts its fp32
        parameters to its input's dtype at each call (``layers.Conv``)."""
        cast_weights(self, dtype)
        self.dtype = dtype
        return self

    def extract_feat(self, img):
        """backbone (+ neck) features of an NCHW image batch."""
        x = self.backbone(img)
        if self.neck is not None:
            x = self.neck(x)
        return x

    def forward(self, img):
        """img (B, H, W, 3), normalized -> tuple of raw pred maps
        (B, H/s, W/s, A*attrib)."""
        x = img.to(self.dtype).permute(0, 3, 1, 2)
        return self.bbox_head(self.extract_feat(x))

    def loss(self, pred_maps, gt_bboxes, gt_labels, gt_valid):
        """The head's training loss of the pred maps (fp32)."""
        return self.bbox_head.loss(pred_maps, gt_bboxes, gt_labels, gt_valid)

    def get_bboxes(self, pred_maps, **kwargs):
        """The head's ``get_bboxes`` with the config's ``test_cfg``
        translated to its arguments (``tpudet/models/detectors/
        single_stage.py:49-67``): the ``nms`` dict gives ``iou_thr``, a
        ``nms_type`` other than ``'nms'`` and soft-NMS's ``sigma``,
        ``min_score`` and ``method``; ``nms_pre <= 0`` (the reference's
        -1, uncapped) becomes 0; ``min_bbox_size`` and ``strip_test_keys``
        are dropped. ``kwargs`` override."""
        cfg = dict(self.test_cfg or {})
        nms_cfg = cfg.pop('nms', None)
        if nms_cfg is not None:
            cfg['iou_thr'] = nms_cfg.get('iou_threshold',
                                         self.default_iou_thr)
            if nms_cfg.get('type', 'nms') != 'nms':
                cfg['nms_type'] = nms_cfg['type']
            for key in ('sigma', 'min_score', 'method'):
                if key in nms_cfg:
                    cfg[key] = nms_cfg[key]
        cfg.pop('min_bbox_size', None)
        for key in self.strip_test_keys:
            cfg.pop(key, None)
        if 'nms_pre' in cfg and cfg['nms_pre'] <= 0:
            cfg['nms_pre'] = 0
        cfg.update(kwargs)
        return self.bbox_head.get_bboxes(pred_maps, **cfg)


@DETECTORS.register_module()
class YOLOV4(SingleStageDetector):
    """Named alias, mirroring the reference detector registry."""


@DETECTORS.register_module()
class YOLOV5(SingleStageDetector):
    """Named alias, mirroring the reference detector registry."""


@DETECTORS.register_module()
class YOLOV3(SingleStageDetector):
    """YOLOv3 (reference mmdet/models/detectors/yolo.py)."""
    default_iou_thr = 0.45


@DETECTORS.register_module()
class RetinaNet(SingleStageDetector):
    """The generic anchor path (reference
    mmdet/models/detectors/retinanet.py)."""
    default_iou_thr = 0.5


@DETECTORS.register_module()
class ATSS(SingleStageDetector):
    """ATSS (reference mmdet/models/detectors/atss.py)."""
    default_iou_thr = 0.6


@DETECTORS.register_module()
class GFL(ATSS):
    """GFL (reference mmdet/models/detectors/gfl.py)."""


@DETECTORS.register_module()
class VFNet(SingleStageDetector):
    """VarifocalNet (reference mmdet/models/detectors/vfnet.py)."""
    default_iou_thr = 0.6
