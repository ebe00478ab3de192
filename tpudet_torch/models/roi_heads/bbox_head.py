"""RoI bbox heads: port of ``tpudet/models/roi_heads/bbox_head.py``.

``Shared2FCBBoxHead``: the pooled RoI features (..., 7, 7, C) flattened
in tpudet's HWC order, two shared FCs with ReLU, then the softmax
classifier (C + 1 logits, background last) and the class-specific
DeltaXYWH regression (4C, or 4 when class-agnostic). The shared FCs draw
``xavier_uniform``, ``fc_cls`` N(0, 0.01^2), ``fc_reg`` N(0, 0.001^2), all
with zero biases. The port pools straight into that layout
(``ops/roi_align.py``), so ``shared_fc0``'s rows match tpudet's kernel
without a permutation.

``Shared4Conv1FCBBoxHead`` (``bbox_head.py:48-97``, the GN and GN+WS
configs): four 3x3 convs (``shared_conv{i}``, ``he_normal``; a
``WSConv`` with ``conv_ws``; a bias only without a norm), each followed by
the norm (``shared_norm{i}``) and ReLU, then one shared FC and the same
``fc_cls``/``fc_reg`` pair. The conv output is flattened in HWC order,
as tpudet's NHWC reshape.
"""
from __future__ import annotations

from typing import Sequence

import torch.nn.functional as F
from torch import nn

from ...registry import HEADS
from ..layers import Conv, Dense
from ..plugins import WSConv, make_norm


@HEADS.register_module()
class Shared2FCBBoxHead(nn.Module):
    """The keyword arguments are tpudet's fields (``bbox_head.py:17-25``)
    with its defaults."""

    def __init__(self, num_classes: int, in_channels: int = 256,
                 roi_feat_size: int = 7, fc_out_channels: int = 1024,
                 reg_class_agnostic: bool = False,
                 target_stds: Sequence[float] = (0.1, 0.1, 0.2, 0.2),
                 dtype=None):
        super().__init__()
        if dtype is not None:
            raise ValueError(f'Shared2FCBBoxHead: dtype={dtype!r} is not a '
                             f'module setting in the port; see '
                             f'TwoStageDetector.set_dtype')
        self.num_classes = num_classes
        self.target_stds = tuple(target_stds)
        flat = in_channels * roi_feat_size * roi_feat_size
        self.shared_fc0 = Dense(flat, fc_out_channels)
        self.shared_fc1 = Dense(fc_out_channels, fc_out_channels)
        self.fc_cls = Dense(fc_out_channels, num_classes + 1,
                            kernel_init=('normal', 0.01))
        self.fc_reg = Dense(fc_out_channels,
                            4 if reg_class_agnostic else 4 * num_classes,
                            kernel_init=('normal', 0.001))

    def forward(self, roi_feats):
        """roi_feats (..., 7, 7, C) -> (class logits (..., C + 1), deltas
        (..., 4C or 4))."""
        x = roi_feats.reshape(roi_feats.shape[:-3] + (-1,))
        x = F.relu(self.shared_fc0(x))
        x = F.relu(self.shared_fc1(x))
        return self.fc_cls(x), self.fc_reg(x)



@HEADS.register_module()
class Shared4Conv1FCBBoxHead(nn.Module):
    """The keyword arguments are tpudet's fields (``bbox_head.py:52-65``)
    with its defaults."""

    def __init__(self, num_classes: int, in_channels: int = 256,
                 conv_out_channels: int = 256, roi_feat_size: int = 7,
                 fc_out_channels: int = 1024,
                 reg_class_agnostic: bool = False,
                 target_stds: Sequence[float] = (0.1, 0.1, 0.2, 0.2),
                 norm=None, gn_groups: int = 32, conv_ws: bool = False,
                 dtype=None):
        super().__init__()
        if dtype is not None:
            raise ValueError(f'Shared4Conv1FCBBoxHead: dtype={dtype!r} is '
                             f'not a module setting in the port; see '
                             f'TwoStageDetector.set_dtype')
        self.num_classes = num_classes
        self.target_stds = tuple(target_stds)
        self.norm = norm
        cin = in_channels
        for i in range(4):
            bias = norm is None
            self.add_module(f'shared_conv{i}', (
                WSConv(cin, conv_out_channels, 3, bias=bias) if conv_ws else
                Conv(cin, conv_out_channels, 3, padding=1, bias=bias)))
            if norm is not None:
                self.add_module(f'shared_norm{i}', make_norm(
                    norm, conv_out_channels, gn_groups))
            cin = conv_out_channels
        self.shared_fc = Dense(conv_out_channels * roi_feat_size ** 2,
                               fc_out_channels)
        self.fc_cls = Dense(fc_out_channels, num_classes + 1,
                            kernel_init=('normal', 0.01))
        self.fc_reg = Dense(fc_out_channels,
                            4 if reg_class_agnostic else 4 * num_classes,
                            kernel_init=('normal', 0.001))

    def forward(self, roi_feats):
        """roi_feats (..., 7, 7, C) -> (class logits (..., C + 1), deltas
        (..., 4C or 4))."""
        lead = roi_feats.shape[:-3]
        x = roi_feats.reshape((-1,) + roi_feats.shape[-3:]).permute(0, 3, 1,
                                                                      2)
        for i in range(4):
            x = getattr(self, f'shared_conv{i}')(x)
            if self.norm is not None:
                x = getattr(self, f'shared_norm{i}')(x)
            x = F.relu(x)
        x = F.relu(self.shared_fc(x.permute(0, 2, 3, 1).reshape(lead + (-1,))))
        return self.fc_cls(x), self.fc_reg(x)
