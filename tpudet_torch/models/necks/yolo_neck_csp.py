"""YOLOv4 and YOLOv5 PANet-CSP necks: port of
``tpudet/models/necks/yolo_neck_csp.py``.

Top-down upsample + concat + CSP merge, then bottom-up stride-2 conv +
concat + CSP merge.

- ``YOLOV4Neck``: 1x1 lateral convs on the backbone maps, ``BottleneckCSP2``
  merges, 3x3 output convs; the bottom-up path concatenates the *input* of
  each pre-upsample conv.
- ``YOLOV5Neck``: no lateral or output convs, ``BottleneckCSP`` merges
  without shortcuts; the bottom-up path concatenates the *output* of each
  pre-upsample conv, and its merges end in ``out_channels[i + 1]``.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ...registry import NECKS
from ..backbones.darknet_csp import BottleneckCSP, BottleneckCSP2
from ..layers import ActCfg, ConvModule, upsample_nearest_2x


@NECKS.register_module()
class YOLOV4Neck(nn.Module):

    def __init__(self, in_channels: Sequence[int],
                 out_channels: Sequence[int], csp_repetition: int = 3,
                 act: ActCfg = 'Mish', csp_act: ActCfg = 'Mish'):
        super().__init__()
        self.num_levels = n = len(in_channels)
        kw = dict(act=act)
        csp_kw = dict(act=act, csp_act=csp_act)
        # top-down: levels n-1 .. 1 merge into the level below
        x_ch = in_channels[-1]
        merge_ch = []
        for i in range(n - 1, 0, -1):
            target = in_channels[i - 1] // 2
            self.add_module(f'lateral_conv{i - 1}',
                            ConvModule(in_channels[i - 1], target, 1, **kw))
            merge_ch.append(x_ch)
            self.add_module(f'pre_up_conv{i}',
                            ConvModule(x_ch, target, 1, **kw))
            self.add_module(f'td_csp{i - 1}', BottleneckCSP2(
                2 * target, target, csp_repetition, **csp_kw))
            x_ch = target
        # bottom-up
        outs_ch = [x_ch]
        for i in range(n - 1):
            top = merge_ch.pop(-1)
            self.add_module(f'down_conv{i}',
                            ConvModule(x_ch, top, 3, 2, **kw))
            self.add_module(f'bu_csp{i}', BottleneckCSP2(
                2 * top, top, csp_repetition, **csp_kw))
            x_ch = top
            outs_ch.append(x_ch)
        for i in range(n):
            self.add_module(f'out_conv{i}',
                            ConvModule(outs_ch[i], out_channels[i], 3, **kw))

    def forward(self, inputs):
        assert len(inputs) == self.num_levels
        n = self.num_levels
        x = inputs[-1]
        bottom_up_merge = []
        for i in range(n - 1, 0, -1):
            inputs_bottom = getattr(self, f'lateral_conv{i - 1}')(
                inputs[i - 1])
            # v4: the pre-conv input feeds the bottom-up merge
            bottom_up_merge.append(x)
            x = upsample_nearest_2x(getattr(self, f'pre_up_conv{i}')(x))
            x = getattr(self, f'td_csp{i - 1}')(
                torch.cat([inputs_bottom, x], dim=1))
        outs = [x]
        for i in range(n - 1):
            merge = bottom_up_merge.pop(-1)
            x = getattr(self, f'down_conv{i}')(x)
            x = getattr(self, f'bu_csp{i}')(torch.cat([x, merge], dim=1))
            outs.append(x)
        return tuple(getattr(self, f'out_conv{i}')(outs[i])
                     for i in range(n))


@NECKS.register_module()
class YOLOV5Neck(nn.Module):

    def __init__(self, in_channels: Sequence[int],
                 out_channels: Sequence[int], csp_repetition: int = 3,
                 act: ActCfg = 'Mish', csp_act: ActCfg = 'Mish'):
        super().__init__()
        self.num_levels = n = len(in_channels)
        kw = dict(act=act)
        csp_kw = dict(act=act, csp_act=csp_act, shortcut=False)
        # top-down: the pre-upsample conv narrows to the level below
        x_ch = in_channels[-1]
        merge_ch = []
        for i in range(n - 1, 0, -1):
            target = in_channels[i - 1]
            self.add_module(f'pre_up_conv{i}',
                            ConvModule(x_ch, target, 1, **kw))
            merge_ch.append(target)
            self.add_module(f'td_csp{i - 1}', BottleneckCSP(
                2 * target, target, csp_repetition, **csp_kw))
            x_ch = target
        # bottom-up
        for i in range(n - 1):
            top = merge_ch.pop(-1)
            self.add_module(f'down_conv{i}',
                            ConvModule(x_ch, top, 3, 2, **kw))
            self.add_module(f'bu_csp{i}', BottleneckCSP(
                2 * top, out_channels[i + 1], csp_repetition, **csp_kw))
            x_ch = out_channels[i + 1]

    def forward(self, inputs):
        assert len(inputs) == self.num_levels
        n = self.num_levels
        x = inputs[-1]
        bottom_up_merge = []
        for i in range(n - 1, 0, -1):
            x = getattr(self, f'pre_up_conv{i}')(x)
            # v5: the post-conv output feeds the bottom-up merge
            bottom_up_merge.append(x)
            x = getattr(self, f'td_csp{i - 1}')(
                torch.cat([inputs[i - 1], upsample_nearest_2x(x)], dim=1))
        outs = [x]
        for i in range(n - 1):
            merge = bottom_up_merge.pop(-1)
            x = getattr(self, f'down_conv{i}')(x)
            x = getattr(self, f'bu_csp{i}')(torch.cat([x, merge], dim=1))
            outs.append(x)
        return tuple(outs)
