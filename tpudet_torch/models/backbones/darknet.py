"""Darknet-53, YOLOv3's backbone: port of
``tpudet/models/backbones/darknet.py``.

A 3x3 stem conv of 32 channels, then five stages of a stride-2 3x3 conv
(``stage{i}_down``) and 1, 2, 8, 8, 4 residual blocks (``stage{i}_block{j}``:
a 1x1 conv to half the width, a 3x3 conv back, plus the input). Every
conv is the port's ``ConvModule`` with tpudet's ConvModule defaults, BN
eps 1e-5 and momentum 0.1 (flax 0.9), and LeakyReLU(0.1).
"""
from __future__ import annotations

from typing import Sequence

from torch import nn

from ...registry import BACKBONES
from ..layers import ConvModule

LEAKY = dict(type='LeakyReLU', negative_slope=0.1)
# tpudet's ConvModule BN defaults (torch's), not the CSP family's
BN = dict(bn_eps=1e-5, bn_momentum=0.1)


def conv_module(cin, cout, kernel, stride=1):
    """YOLOv3's conv + BN + LeakyReLU(0.1)."""
    return ConvModule(cin, cout, kernel, stride, act=LEAKY, **BN)


class ResBlock(nn.Module):

    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = conv_module(channels, channels // 2, 1)
        self.conv2 = conv_module(channels // 2, channels, 3)

    def forward(self, x):
        return self.conv2(self.conv1(x)) + x


@BACKBONES.register_module()
class Darknet(nn.Module):
    """``forward`` takes an NCHW image batch and returns the outputs of the
    stages in ``out_indices`` (1-based), NCHW."""

    arch_settings = {
        53: ((1, 2, 8, 8, 4), ((32, 64), (64, 128), (128, 256), (256, 512),
                               (512, 1024)))
    }

    def __init__(self, depth: int = 53,
                 out_indices: Sequence[int] = (3, 4, 5), dtype=None):
        super().__init__()
        if depth not in self.arch_settings:
            raise KeyError(f'invalid depth {depth} for Darknet')
        if dtype is not None:
            raise ValueError(f'Darknet: dtype={dtype!r} is not a module '
                             f'setting in the port; see '
                             f'SingleStageDetector.set_dtype')
        self.out_indices = tuple(out_indices)
        layers, channels = self.arch_settings[depth]
        self.conv1 = conv_module(3, 32, 3)
        self.num_blocks = layers
        for i, (n, (cin, cout)) in enumerate(zip(layers, channels)):
            self.add_module(f'stage{i + 1}_down', conv_module(cin, cout, 3, 2))
            for j in range(n):
                self.add_module(f'stage{i + 1}_block{j}', ResBlock(cout))

    @classmethod
    def out_channels(cls, depth, out_indices):
        _, channels = cls.arch_settings[depth]
        return tuple(channels[i - 1][1] for i in out_indices)

    def forward(self, x):
        x = self.conv1(x)
        outs = []
        for i, n in enumerate(self.num_blocks):
            x = getattr(self, f'stage{i + 1}_down')(x)
            for j in range(n):
                x = getattr(self, f'stage{i + 1}_block{j}')(x)
            if i + 1 in self.out_indices:
                outs.append(x)
        return tuple(outs)
