"""CSPDarknet backbone, YOLOv4 and YOLOv5 scales: port of
``tpudet/models/backbones/darknet_csp.py``.

Same arch table, stage kinds and channel arithmetic; BN eps 1e-3 (the CSP
family's convention), Mish by default. The stem is the plain 3x3 conv:
tpudet's space-to-depth stem is a TPU layout rewrite with an identical
param tree and identical outputs, so weights load either way and
``space_to_depth_stem`` is accepted with either value.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ...registry import BACKBONES
from ..layers import ActCfg, BatchNormAct, Conv2d, ConvModule, max_pool_same

POOLS = (5, 9, 13)  # the SPP blocks' max-pool sizes


class Bottleneck(nn.Module):
    """1x1 -> 3x3 with optional residual."""

    def __init__(self, in_channels: int, out_channels: int,
                 shortcut: bool = True, groups: int = 1,
                 expansion: float = 0.5, act: ActCfg = 'Mish'):
        super().__init__()
        hidden = int(out_channels * expansion)
        self.conv1 = ConvModule(in_channels, hidden, 1, act=act)
        self.conv2 = ConvModule(hidden, out_channels, 3, groups=groups,
                                act=act)
        self.add = shortcut and in_channels == out_channels

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        return x + y if self.add else y


class BottleneckCSP(nn.Module):
    """CSP bottleneck: conv1 -> bottlenecks -> conv3 branch, raw conv2
    branch, shared BN + act over the concat, conv4 merge."""

    def __init__(self, in_channels: int, out_channels: int,
                 repetition: int = 1, shortcut: bool = True, groups: int = 1,
                 expansion: float = 0.5, act: ActCfg = 'Mish',
                 csp_act: ActCfg = 'Mish'):
        super().__init__()
        hidden = int(out_channels * expansion)
        self.conv1 = ConvModule(in_channels, hidden, 1, act=act)
        self.repetition = repetition
        for i in range(repetition):
            self.add_module(f'bottlenecks_{i}', Bottleneck(
                hidden, hidden, shortcut, groups, expansion=1.0, act=act))
        self.conv3 = Conv2d(hidden, hidden)
        self.conv2 = Conv2d(in_channels, hidden)
        self.csp_bn = BatchNormAct(2 * hidden, act=csp_act)
        self.conv4 = ConvModule(2 * hidden, out_channels, 1, act=act)

    def forward(self, x):
        y1 = self.conv1(x)
        for i in range(self.repetition):
            y1 = getattr(self, f'bottlenecks_{i}')(y1)
        y1 = self.conv3(y1)
        y2 = self.conv2(x)
        return self.conv4(self.csp_bn(torch.cat([y1, y2], dim=1)))


class BottleneckCSP2(nn.Module):
    """CSP2 variant of the v4 neck: both branches stem from conv1;
    hidden == out_channels."""

    def __init__(self, in_channels: int, out_channels: int,
                 repetition: int = 1, act: ActCfg = 'Mish',
                 csp_act: ActCfg = 'Mish'):
        super().__init__()
        hidden = out_channels
        self.conv1 = ConvModule(in_channels, hidden, 1, act=act)
        self.repetition = repetition
        for i in range(repetition):
            self.add_module(f'bottlenecks_{i}', Bottleneck(
                hidden, hidden, shortcut=False, expansion=1.0, act=act))
        self.conv2 = Conv2d(hidden, hidden)
        self.csp_bn = BatchNormAct(2 * hidden, act=csp_act)
        self.conv3 = ConvModule(2 * hidden, out_channels, 1, act=act)

    def forward(self, x):
        x1 = self.conv1(x)
        y1 = x1
        for i in range(self.repetition):
            y1 = getattr(self, f'bottlenecks_{i}')(y1)
        y2 = self.conv2(x1)
        return self.conv3(self.csp_bn(torch.cat([y1, y2], dim=1)))


class SPPV5(nn.Module):
    """SPP of YOLOv5: 1x1 shrink to half the input, parallel max pools,
    1x1 merge."""

    def __init__(self, in_channels: int, out_channels: int,
                 act: ActCfg = 'Mish'):
        super().__init__()
        hidden = in_channels // 2
        self.conv1 = ConvModule(in_channels, hidden, 1, act=act)
        self.conv2 = ConvModule(hidden * (1 + len(POOLS)), out_channels, 1,
                                act=act)

    def forward(self, x):
        x = self.conv1(x)
        pools = [max_pool_same(x, k) for k in POOLS]
        return self.conv2(torch.cat([x] + pools, dim=1))


class SPPV4(nn.Module):
    """CSP-SPP of YOLOv4: parallel max pools inside a CSP block."""

    def __init__(self, in_channels: int, out_channels: int,
                 act: ActCfg = 'Mish', csp_act: ActCfg = 'Mish'):
        super().__init__()
        hidden = out_channels
        self.conv1 = ConvModule(in_channels, hidden, 1, act=act)
        self.conv3 = ConvModule(hidden, hidden, 3, act=act)
        self.conv4 = ConvModule(hidden, hidden, 1, act=act)
        self.conv5 = ConvModule(hidden * (1 + len(POOLS)), hidden, 1,
                                act=act)
        self.conv6 = ConvModule(hidden, hidden, 3, act=act)
        self.conv2 = Conv2d(in_channels, hidden)
        self.csp_bn = BatchNormAct(2 * hidden, act=csp_act)
        self.conv7 = ConvModule(2 * hidden, out_channels, 1, act=act)

    def forward(self, x):
        x1 = self.conv4(self.conv3(self.conv1(x)))
        pools = [max_pool_same(x1, k) for k in POOLS]
        y1 = self.conv6(self.conv5(torch.cat([x1] + pools, dim=1)))
        y2 = self.conv2(x)
        return self.conv7(self.csp_bn(torch.cat([y1, y2], dim=1)))


class Focus(nn.Module):
    """YOLOv5 Focus as tpudet writes it: one stride-2 conv with doubled
    kernel and padding (the space-to-depth + conv composition)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 1, stride: int = 1,
                 act: ActCfg = 'Mish'):
        super().__init__()
        self.conv = ConvModule(in_channels, out_channels, kernel_size * 2,
                               stride * 2, padding=(kernel_size // 2) * 2,
                               act=act)

    def forward(self, x):
        return self.conv(x)


@BACKBONES.register_module()
class DarknetCSP(nn.Module):
    """CSPDarknet-53, YOLOv4 and YOLOv5 scales. ``forward`` takes an NCHW
    image batch and returns the ``out_indices`` stage outputs, NCHW."""

    arch_settings = {
        'v4s5p': [['conv', 'bottleneck', 'csp', 'csp', 'csp', 'sppv4'],
                  [None, 1, 1, 3, 3, 1], [16, 32, 64, 128, 256, 256]],
        'v4m5p': [['conv', 'bottleneck', 'csp', 'csp', 'csp', 'sppv4'],
                  [None, 1, 1, 5, 5, 3], [24, 48, 96, 192, 384, 384]],
        'v4l5p': [['conv', 'bottleneck', 'csp', 'csp', 'csp', 'sppv4'],
                  [None, 1, 2, 8, 8, 4], [32, 64, 128, 256, 512, 512]],
        'v4x5p': [['conv', 'bottleneck', 'csp', 'csp', 'csp', 'sppv4'],
                  [None, 1, 3, 11, 11, 5], [40, 80, 160, 320, 640, 640]],
        'v4l6p': [['conv', 'csp', 'csp', 'csp', 'csp', 'csp', 'sppv4'],
                  [None, 1, 3, 15, 15, 7, 7],
                  [32, 64, 128, 256, 512, 1024, 512]],
        'v4x7p': [['conv', 'csp', 'csp', 'csp', 'csp', 'csp', 'csp', 'sppv4'],
                  [None, 1, 3, 15, 15, 7, 7, 7],
                  [40, 80, 160, 320, 640, 1280, 1280, 640]],
        'v5s5p': [['focus', 'csp', 'csp', 'csp', 'sppv5'], [None, 1, 3, 3, 1],
                  [32, 64, 128, 256, 512]],
        'v5m5p': [['focus', 'csp', 'csp', 'csp', 'sppv5'], [None, 2, 6, 6, 2],
                  [48, 96, 192, 384, 768]],
        'v5l5p': [['focus', 'csp', 'csp', 'csp', 'sppv5'], [None, 3, 9, 9, 3],
                  [64, 128, 256, 512, 1024]],
        'v5x5p': [['focus', 'csp', 'csp', 'csp', 'sppv5'],
                  [None, 4, 12, 12, 4], [80, 160, 320, 640, 1280]],
    }

    def __init__(self, scale: str = 'v4l5p',
                 out_indices: Sequence[int] = (3, 4, 5),
                 act: ActCfg = 'Mish', csp_act: ActCfg = 'Mish',
                 space_to_depth_stem: bool = True, dtype=None):
        super().__init__()
        if scale not in self.arch_settings:
            raise KeyError(f'invalid scale {scale} for DarknetCSP')
        if dtype is not None:  # tpudet's module field
            raise ValueError(
                f'DarknetCSP: dtype={dtype!r} is not a module setting in the '
                f'port; set the compute dtype on the detector with '
                f'SingleStageDetector.set_dtype (init_detector(dtype=...)) '
                f"or the config's compute_dtype for training")
        self.out_indices = tuple(out_indices)
        stages, repetitions, channels = self.arch_settings[scale]
        kw = dict(act=act)
        csp_kw = dict(act=act, csp_act=csp_act)
        self.stage_names = []
        cin = 3
        for i, (stg, rep, cout) in enumerate(
                zip(stages, repetitions, channels)):
            name = f'{stg}{i}'
            if stg == 'conv':
                blocks = {name: ConvModule(cin, cout, 3, **kw)}
            elif stg == 'bottleneck':
                # the reference's BottleneckStage passes `repetition` into
                # Bottleneck's `shortcut` slot: one downscale conv and one
                # bottleneck with shortcut; kept for weight parity
                blocks = {f'{name}_down': ConvModule(cin, cout, 3, 2, **kw),
                          f'{name}_block': Bottleneck(
                              cout, cout, shortcut=bool(rep), **kw)}
            elif stg == 'csp':
                blocks = {f'{name}_down': ConvModule(cin, cout, 3, 2, **kw),
                          f'{name}_csp': BottleneckCSP(cout, cout, rep,
                                                       **csp_kw)}
            elif stg == 'focus':
                blocks = {name: Focus(cin, cout, 3, **kw)}
            elif stg == 'sppv4':  # down to 2*cout, CSP, SPP back to cout
                blocks = {f'{name}_down': ConvModule(cin, cout * 2, 3, 2,
                                                     **kw),
                          f'{name}_csp': BottleneckCSP(cout * 2, cout * 2,
                                                       rep, **csp_kw),
                          f'{name}_spp': SPPV4(cout * 2, cout, **csp_kw)}
            else:  # 'sppv5': down, SPP, CSP (with its default shortcut)
                blocks = {f'{name}_down': ConvModule(cin, cout, 3, 2, **kw),
                          f'{name}_spp': SPPV5(cout, cout, **kw),
                          f'{name}_csp': BottleneckCSP(cout, cout, rep,
                                                       **csp_kw)}
            for key, block in blocks.items():
                self.add_module(key, block)
            self.stage_names.append(list(blocks))
            cin = cout

    def forward(self, x):
        outs = []
        for i, names in enumerate(self.stage_names):
            for name in names:
                x = getattr(self, name)(x)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)
