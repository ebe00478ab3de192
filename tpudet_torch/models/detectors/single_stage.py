"""Single-stage detector: backbone -> neck -> dense head. Port of
``tpudet/models/detectors/single_stage.py`` (``SingleStageDetector``,
``YOLOV4``, ``YOLOV5``)."""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ...registry import DETECTORS


@DETECTORS.register_module()
class SingleStageDetector(nn.Module):

    default_iou_thr = 0.65  # NMS IoU when the config omits it

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
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                m.to(dtype)
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
        translated to its arguments; ``kwargs`` override."""
        cfg = dict(self.test_cfg or {})
        nms_cfg = cfg.pop('nms', None)
        if nms_cfg is not None:
            cfg['iou_thr'] = nms_cfg.get('iou_threshold',
                                         self.default_iou_thr)
            if nms_cfg.get('type', 'nms') != 'nms':
                cfg['nms_type'] = nms_cfg['type']
        cfg.pop('min_bbox_size', None)
        cfg.update(kwargs)
        return self.bbox_head.get_bboxes(pred_maps, **cfg)


@DETECTORS.register_module()
class YOLOV4(SingleStageDetector):
    """Named alias, mirroring the reference detector registry."""


@DETECTORS.register_module()
class YOLOV5(SingleStageDetector):
    """Named alias, mirroring the reference detector registry."""
