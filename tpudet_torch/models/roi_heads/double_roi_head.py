"""Double-Head R-CNN: port of ``tpudet/models/roi_heads/double_roi_head.py``
(``DoubleConvFCBBoxHead``, ``DoubleHeadRoIHead``, ``DoubleHeadRCNN``).

``DoubleConvFCBBoxHead`` splits the pooled (N, 7, 7, C) RoI features into
two branches:

- regression, a conv branch (``:35-53``): a ``BasicResBlock``, that is a
  1x1 downsample to 1024 with BN (``res_ds_conv``, ``res_ds_bn``) beside
  a 3x3 at C with BN and ReLU (``res_conv1``, ``res_bn1``) and a 1x1 to
  1024 with BN (``res_conv2``, ``res_bn2``), ReLU on the sum; then four
  ResNet bottlenecks of width 256 (``conv_branch{i}``, the backbone's
  ``Bottleneck``), a global average pool and ``fc_reg`` (4C outputs,
  N(0, 0.001^2));
- classification, an FC branch (``:55-64``): the features flattened in
  HWC order, ``fc0`` and ``fc1`` (1024, ReLU, ``xavier_uniform``), then
  ``fc_cls`` (C + 1 logits, N(0, 0.01^2)).

Every conv is bias-free ``he_normal`` and every BN is the port's
``BatchNorm2d`` (eps 1e-5, flax's momentum 0.9): in training it
normalizes over every one of the B x S roi slots, the unsampled ones
(pooled as zeros) included, as tpudet's does, and under a process group
over every rank's slots (SyncBN).

``DoubleHeadRoIHead`` is ``StandardRoIHead`` with this bbox head and both
loss terms times 2.0 (``:78-85``); the detector is Faster R-CNN's.
"""
from __future__ import annotations

from typing import Dict

import torch.nn.functional as F
from torch import nn

from ...registry import DETECTORS, HEADS
from ..backbones.resnet import BN_EPS, BN_MOMENTUM, Bottleneck
from ..detectors.two_stage import TwoStageDetector
from ..layers import BatchNorm2d, Conv, Dense
from .standard_roi_head import StandardRoIHead


def _bn(channels):
    return BatchNorm2d(channels, eps=BN_EPS, momentum=BN_MOMENTUM)


class DoubleConvFCBBoxHead(nn.Module):
    """The keyword arguments are tpudet's fields (``double_roi_head.py:
    22-28``) with its defaults, and the input's channels and size."""

    def __init__(self, num_classes: int, in_channels: int = 256,
                 roi_feat_size: int = 7, num_convs: int = 4,
                 num_fcs: int = 2, conv_out_channels: int = 1024,
                 fc_out_channels: int = 1024):
        super().__init__()
        co = conv_out_channels
        self.num_convs, self.num_fcs = num_convs, num_fcs
        self.res_ds_conv = Conv(in_channels, co, 1, bias=False)
        self.res_ds_bn = _bn(co)
        self.res_conv1 = Conv(in_channels, in_channels, 3, 1, 1, bias=False)
        self.res_bn1 = _bn(in_channels)
        self.res_conv2 = Conv(in_channels, co, 1, bias=False)
        self.res_bn2 = _bn(co)
        for i in range(num_convs):
            self.add_module(f'conv_branch{i}', Bottleneck(co, co // 4))
        self.fc_reg = Dense(co, 4 * num_classes, kernel_init=('normal', 0.001))
        cin = in_channels * roi_feat_size ** 2
        for i in range(num_fcs):
            self.add_module(f'fc{i}', Dense(cin, fc_out_channels))
            cin = fc_out_channels
        self.fc_cls = Dense(cin, num_classes + 1, kernel_init=('normal', 0.01))

    def forward(self, roi_feats):
        """roi_feats (..., 7, 7, C) -> (class logits (..., C + 1), deltas
        (..., 4C))."""
        lead = roi_feats.shape[:-3]
        flat = roi_feats.reshape((-1,) + roi_feats.shape[-3:])
        x = flat.permute(0, 3, 1, 2)
        identity = self.res_ds_bn(self.res_ds_conv(x))
        v = F.relu(self.res_bn1(self.res_conv1(x)))
        x = F.relu(self.res_bn2(self.res_conv2(v)) + identity)
        for i in range(self.num_convs):
            x = getattr(self, f'conv_branch{i}')(x)
        deltas = self.fc_reg(x.mean(dim=(2, 3)))
        y = flat.reshape(flat.shape[0], -1)
        for i in range(self.num_fcs):
            y = F.relu(getattr(self, f'fc{i}')(y))
        cls = self.fc_cls(y)
        return cls.reshape(lead + (-1,)), deltas.reshape(lead + (-1,))


@HEADS.register_module()
class DoubleHeadRoIHead(StandardRoIHead):
    """``StandardRoIHead``'s keyword arguments and tpudet's loss weights
    (``double_roi_head.py:71-72``)."""

    def __init__(self, num_classes: int, in_channels: int = 256,
                 reg_loss_weight: float = 2.0, cls_loss_weight: float = 2.0,
                 **kwargs):
        super().__init__(num_classes, in_channels, **kwargs)
        self.bbox_head = DoubleConvFCBBoxHead(num_classes, in_channels,
                                              roi_feat_size=self.roi_size)
        self.reg_loss_weight = reg_loss_weight
        self.cls_loss_weight = cls_loss_weight

    def loss(self, cls_logits, deltas, labels, targets, pos, sampled,
             rois=None) -> Dict:
        out = super().loss(cls_logits, deltas, labels, targets, pos, sampled)
        out['loss_cls'] = out['loss_cls'] * self.cls_loss_weight
        out['loss_bbox'] = out['loss_bbox'] * self.reg_loss_weight
        return out


@DETECTORS.register_module()
class DoubleHeadRCNN(TwoStageDetector):
    """Named alias for configs (reference configs/double_heads)."""
