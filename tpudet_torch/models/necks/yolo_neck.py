"""YOLOv3's neck: port of ``tpudet/models/necks/yolo_neck.py``.

``DetectionBlock``: five convs, 1x1 / 3x3 alternating (``conv1..5``, c,
2c, c, 2c, c). ``YOLOV3Neck`` runs the deepest level first: its block
(``detect1``), then for each shallower level a 1x1 conv (``conv{i}``),
the nearest 2x upsample, the concat with that level's input (upsampled
first) and its block (``detect{i + 1}``). Convs as Darknet's.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ...registry import NECKS
from ..backbones.darknet import conv_module
from ..layers import upsample_nearest_2x


class DetectionBlock(nn.Module):

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        c = out_channels
        self.conv1 = conv_module(in_channels, c, 1)
        self.conv2 = conv_module(c, 2 * c, 3)
        self.conv3 = conv_module(2 * c, c, 1)
        self.conv4 = conv_module(c, 2 * c, 3)
        self.conv5 = conv_module(2 * c, c, 1)

    def forward(self, x):
        for i in range(1, 6):
            x = getattr(self, f'conv{i}')(x)
        return x


@NECKS.register_module()
class YOLOV3Neck(nn.Module):
    """``in_channels`` and ``out_channels`` deepest level first (e.g.
    [1024, 512, 256] -> [512, 256, 128]); ``forward`` takes the backbone's
    maps shallowest first and returns the blocks' outputs deepest first."""

    def __init__(self, num_scales: int, in_channels: Sequence[int],
                 out_channels: Sequence[int], dtype=None):
        super().__init__()
        if dtype is not None:
            raise ValueError(f'YOLOV3Neck: dtype={dtype!r} is not a module '
                             f'setting in the port; see '
                             f'SingleStageDetector.set_dtype')
        self.num_scales = num_scales
        self.detect1 = DetectionBlock(in_channels[0], out_channels[0])
        for i in range(1, num_scales):
            self.add_module(f'conv{i}', conv_module(out_channels[i - 1],
                                                    out_channels[i], 1))
            self.add_module(f'detect{i + 1}', DetectionBlock(
                out_channels[i] + in_channels[i], out_channels[i]))

    def forward(self, feats):
        assert len(feats) == self.num_scales
        out = self.detect1(feats[-1])
        outs = [out]
        for i, x in enumerate(reversed(feats[:-1])):
            tmp = upsample_nearest_2x(getattr(self, f'conv{i + 1}')(out))
            out = getattr(self, f'detect{i + 2}')(torch.cat([tmp, x], dim=1))
            outs.append(out)
        return tuple(outs)
