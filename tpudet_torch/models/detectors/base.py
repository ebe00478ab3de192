"""What the two-stage and proposal detectors share: the backbone and
neck, the configs and the compute dtype (as ``SingleStageDetector``)."""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..layers import cast_weights


class BaseDetector(nn.Module):

    def __init__(self, backbone: nn.Module, neck: Optional[nn.Module] = None,
                 train_cfg: Optional[Dict] = None,
                 test_cfg: Optional[Dict] = None):
        super().__init__()
        self.backbone = backbone
        self.neck = neck
        self.train_cfg = train_cfg
        self.test_cfg = test_cfg
        self.dtype = torch.float32

    def set_dtype(self, dtype: torch.dtype) -> 'BaseDetector':
        """Compute dtype for inference: conv and dense weights are stored
        in it, BatchNorm keeps fp32 (``SingleStageDetector.set_dtype``).
        Training sets only ``self.dtype``, the image's dtype; every layer
        then casts its fp32 parameters to its input's dtype."""
        cast_weights(self, dtype)
        self.dtype = dtype
        return self

    def extract_feat(self, img):
        """NCHW backbone (+ neck) features of an NHWC normalized image
        batch, in the compute dtype."""
        x = self.backbone(img.to(self.dtype).permute(0, 3, 1, 2))
        if self.neck is not None:
            x = self.neck(x)
        return x

