"""NAS-FCOS's searched FPN: port of ``tpudet/models/necks/nasfcos_fpn.py``
(``_resize_to``, ``ConcatCell``, ``NASFCOS_FPN``).

C3-C5 (from ``start_level``) are adapted by a bias-free 1x1 conv, BN and
ReLU (``adapt{i}``, ``adapt_bn{i}``), then seven ``ConcatCell``s wire the
searched topology; P3-P5 are ``f9``, ``f8``, ``f7`` each plus ``f5``
brought to its size, resized to C3-C5's sizes (bilinear as
``jax.image.resize``, antialiased when it shrinks: ``ops/resize.py``);
the extra levels are BN (a ReLU before all but the first) and a 3x3
stride-2 conv with flax's ``'SAME'`` padding (``SameConv``: the odd pixel
of padding goes below and right). Every conv draws ``he_normal``; BN
takes flax's momentum 0.9 and eps 1e-5.

A ``ConcatCell`` runs an optional 3x3 conv + ReLU on each input, brings
both to the larger size (``resize_to``), concatenates them, and applies
BN, ReLU and a bias-free 1x1 conv grouped by ``out_channels`` (each
output channel mixes its own pair of inputs).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.deform_conv import same_padding
from ...ops.resize import resize_bilinear
from ...registry import NECKS
from ..layers import BatchNorm2d, Conv, upsample_nearest_2x

BN_MOMENTUM, BN_EPS = 0.1, 1e-5  # flax momentum 0.9


def resize_to(x: torch.Tensor, hw) -> torch.Tensor:
    """tpudet's ``_resize_to`` on NCHW: up by nearest 2x until both sides
    reach ``hw`` when the height grows, then cropped; else down by a
    max-pool of ``max(h // th, 1)`` (floor), then cropped."""
    h, w = x.shape[2:]
    th, tw = hw
    if (h, w) == (th, tw):
        return x
    if th > h:
        while x.shape[2] < th or x.shape[3] < tw:
            x = upsample_nearest_2x(x)
        return x[:, :, :th, :tw]
    f = max(h // th, 1)
    return F.max_pool2d(x, f, f)[:, :, :th, :tw]


class SameConv(Conv):
    """A conv with flax's ``'SAME'`` padding at any stride (the smaller
    half of the padding above and left), ``he_normal`` unless given."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int, stride: int = 1, **kwargs):
        super().__init__(in_channels, out_channels, kernel_size, stride, 0,
                         **kwargs)

    def forward(self, x):
        k, s = self.kernel_size[0], self.stride[0]
        (top, bottom), (left, right) = (same_padding(n, k, s)
                                        for n in x.shape[2:])
        return super().forward(F.pad(x, (left, right, top, bottom)))


class ConcatCell(nn.Module):
    """tpudet's ``ConcatCell(out_channels, with_input1_conv,
    with_input2_conv)``."""

    def __init__(self, channels: int, with_input1_conv: bool = False,
                 with_input2_conv: bool = False):
        super().__init__()
        if with_input1_conv:
            self.input1_conv = Conv(channels, channels, 3, 1, 1)
        if with_input2_conv:
            self.input2_conv = Conv(channels, channels, 3, 1, 1)
        self.out_bn = BatchNorm2d(2 * channels, eps=BN_EPS,
                                  momentum=BN_MOMENTUM)
        self.out_conv = Conv(2 * channels, channels, 1, groups=channels,
                             bias=False)

    def forward(self, x1, x2):
        if hasattr(self, 'input1_conv'):
            x1 = F.relu(self.input1_conv(x1))
        if hasattr(self, 'input2_conv'):
            x2 = F.relu(self.input2_conv(x2))
        hw = max(tuple(x1.shape[2:]), tuple(x2.shape[2:]))
        x = torch.cat([resize_to(x1, hw), resize_to(x2, hw)], dim=1)
        return self.out_conv(F.relu(self.out_bn(x)))


# (name, input 1, input 2, input 1 conv, input 2 conv) over f0..f2 = C3..C5
WIRING = (('c22_1', 2, 2, True, True), ('c22_2', 2, 2, True, True),
          ('c32', 3, 2, True, False), ('c02', 0, 2, True, False),
          ('c42', 4, 2, True, True), ('c36', 3, 6, True, True),
          ('c61', 6, 1, True, True))


@NECKS.register_module()
class NASFCOS_FPN(nn.Module):
    """The keyword arguments are tpudet's fields
    (``nasfcos_fpn.py:76-82``). ``forward`` takes the backbone's NCHW
    outputs and returns ``num_outs`` NCHW levels."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 num_outs: int = 5, start_level: int = 1, dtype=None):
        super().__init__()
        if dtype is not None:
            raise ValueError(f'NASFCOS_FPN: dtype={dtype!r} is not a module '
                             f'setting in the port; see the detector\'s '
                             f'set_dtype')
        self.in_channels = tuple(in_channels)
        self.start_level = start_level
        self.num_outs = num_outs
        c = out_channels
        for i in range(start_level, len(self.in_channels)):
            self.add_module(f'adapt{i}', Conv(self.in_channels[i], c, 1,
                                              bias=False))
            self.add_module(f'adapt_bn{i}', BatchNorm2d(
                c, eps=BN_EPS, momentum=BN_MOMENTUM))
        for name, _, _, w1, w2 in WIRING:
            self.add_module(name, ConcatCell(c, w1, w2))
        for i in range(num_outs - 3):
            self.add_module(f'extra_bn{i}', BatchNorm2d(
                c, eps=BN_EPS, momentum=BN_MOMENTUM))
            self.add_module(f'extra_conv{i}', SameConv(c, c, 3, 2))

    def forward(self, inputs):
        feats = [F.relu(getattr(self, f'adapt_bn{i}')(
            getattr(self, f'adapt{i}')(inputs[i])))
            for i in range(self.start_level, len(self.in_channels))]
        for name, i1, i2, _, _ in WIRING:
            feats.append(getattr(self, name)(feats[i1], feats[i2]))
        outs = []
        for idx, input_idx in zip((9, 8, 7), (1, 2, 3)):
            f1, f5 = feats[idx], feats[5]
            s = f1 + resize_bilinear(f5, f5.shape[:2] + f1.shape[2:])
            outs.append(resize_bilinear(
                s, s.shape[:2] + inputs[input_idx].shape[2:]))
        for i in range(self.num_outs - len(outs)):
            x = outs[-1]
            if i > 0:
                x = F.relu(x)
            x = getattr(self, f'extra_bn{i}')(x)
            outs.append(getattr(self, f'extra_conv{i}')(x))
        return tuple(outs)
