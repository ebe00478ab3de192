"""NAS-FCOS head and detector: port of
``tpudet/models/dense_heads/nasfcos_head.py`` (``NASFCOSHead``,
``NASFCOS``).

``FCOSHead`` with the searched towers: modulated deformable 3x3
(``{branch}_dcn0``, a bias, its offsets and mask from a zero-init
``conv_offset``), 3x3 conv, modulated deformable 3x3, 1x1 conv (bias-free,
``he_normal``), each followed by flax's ``GroupNorm(gn_groups)`` (eps
1e-6) and ReLU. The deformable convs sample and contract in fp32
(``ops/deform_conv.py``); their GroupNorm normalises that fp32 output and
returns the tower's dtype, as flax's GroupNorm with ``dtype`` does. The
prediction convs, the scales, the loss and the decode are FCOS's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...ops.deform_conv import ModulatedDeformConv2d
from ...registry import DETECTORS, HEADS
from ..detectors.single_stage import SingleStageDetector
from ..layers import Conv
from ..plugins import GroupNorm
from .fcos_head import FCOSHead

ARCH = (('dcn', 3), ('conv', 3), ('dcn', 3), ('conv', 1))
GN_EPS = 1e-6  # flax's nn.GroupNorm default


@HEADS.register_module()
class NASFCOSHead(FCOSHead):
    """``FCOSHead``'s keyword arguments and ``gn_groups``."""

    def __init__(self, num_classes: int, gn_groups: int = 32, **kwargs):
        self.gn_groups = gn_groups
        super().__init__(num_classes, **kwargs)

    def build_towers(self, in_channels, feat_channels):
        for branch in ('cls', 'reg'):
            cin = in_channels
            for i, (kind, k) in enumerate(ARCH):
                if kind == 'dcn':
                    self.add_module(f'{branch}_dcn{i}', ModulatedDeformConv2d(
                        cin, feat_channels, k, bias=True))
                else:
                    self.add_module(f'{branch}_conv{i}', Conv(
                        cin, feat_channels, k, 1, k // 2, bias=False))
                self.add_module(f'{branch}_gn{i}', GroupNorm(
                    self.gn_groups, feat_channels, eps=GN_EPS))
                cin = feat_channels

    def tower(self, branch: str, x):
        for i, (kind, _) in enumerate(ARCH):
            y = getattr(self, f'{branch}_{kind}{i}')(x)
            y = y.to(torch.promote_types(y.dtype, x.dtype))
            x = F.relu(getattr(self, f'{branch}_gn{i}')(y).to(x.dtype))
        return x


@DETECTORS.register_module()
class NASFCOS(SingleStageDetector):
    """NAS-FCOS (reference mmdet/models/detectors/nasfcos.py): the NMS
    IoU defaults to 0.6."""
    default_iou_thr = 0.6
