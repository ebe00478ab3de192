"""``ChannelMapper`` and YOLOF's ``DilatedEncoder``: port of
``tpudet/models/necks/channel_mapper.py``.

- ``ChannelMapper``: a ``ConvModule`` a level to ``out_channels``
  (``conv{i}``; BN with tpudet's ConvModule defaults, flax's momentum 0.9
  and eps 1e-5, and no conv bias, or a biased conv without ``use_norm``),
  then stride-2 3x3 ``extra_conv{i}`` off the last input and then the last
  extra output.
- ``DilatedEncoder``: the last level through a 1x1 ``lateral_conv`` and a
  3x3 ``fpn_conv`` (biased, ``xavier_uniform``), each with a BN of flax's
  momentum 0.9 and eps 1e-5 and no activation, then ``block{i}``, one
  ``DilatedBottleneck`` a dilation: a 1x1 ``ConvModule`` (biased, ReLU),
  a dilated 3x3 ``conv2`` (N(0, 0.01^2), biased) with ``bn2`` and ReLU,
  a 1x1 ``ConvModule`` (biased, ReLU), and the block's input added.
  Returns a 1-tuple.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch.nn.functional as F
from torch import nn

from ...registry import NECKS
from ..layers import BatchNorm2d, Conv, ConvModule

# tpudet's BN_MOMENTUM, BN_EPS (flax momentum 0.9 is torch's 0.1)
BN_MOMENTUM, BN_EPS = 0.1, 1e-5


def _no_dtype(name, dtype):
    if dtype is not None:
        raise ValueError(f'{name}: dtype={dtype!r} is not a module setting '
                         f'in the port; see the detector\'s set_dtype')


@NECKS.register_module()
class ChannelMapper(nn.Module):
    """The keyword arguments are tpudet's fields
    (``channel_mapper.py:25-32``)."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 kernel_size: int = 3, num_outs: Optional[int] = None,
                 act: Optional[Union[str, dict]] = 'ReLU',
                 use_norm: bool = False, dtype=None):
        super().__init__()
        _no_dtype('ChannelMapper', dtype)
        self.in_channels = tuple(in_channels)
        self.num_outs = num_outs or len(self.in_channels)
        for i, cin in enumerate(self.in_channels):
            self.add_module(f'conv{i}', ConvModule(
                cin, out_channels, kernel_size, act=act, use_norm=use_norm,
                bias=not use_norm, bn_eps=BN_EPS, bn_momentum=BN_MOMENTUM))
        cin = self.in_channels[-1]
        for i in range(self.num_outs - len(self.in_channels)):
            self.add_module(f'extra_conv{i}', ConvModule(
                cin, out_channels, 3, stride=2, act=act, use_norm=use_norm,
                bias=not use_norm, bn_eps=BN_EPS, bn_momentum=BN_MOMENTUM))
            cin = out_channels

    def forward(self, inputs):
        assert len(inputs) == len(self.in_channels)
        outs = [getattr(self, f'conv{i}')(x) for i, x in enumerate(inputs)]
        for i in range(self.num_outs - len(inputs)):
            src = inputs[-1] if i == 0 else outs[-1]
            outs.append(getattr(self, f'extra_conv{i}')(src))
        return tuple(outs)


class DilatedBottleneck(nn.Module):
    """tpudet's ``DilatedBottleneck(mid_channels, out_channels,
    dilation)``."""

    def __init__(self, in_channels: int, mid_channels: int,
                 out_channels: int, dilation: int):
        super().__init__()
        self.conv1 = ConvModule(in_channels, mid_channels, 1, act='ReLU',
                                bias=True, bn_eps=BN_EPS,
                                bn_momentum=BN_MOMENTUM)
        self.conv2 = Conv(mid_channels, mid_channels, 3, 1, dilation,
                          dilation=dilation, kernel_init=('normal', 0.01))
        self.bn2 = BatchNorm2d(mid_channels, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.conv3 = ConvModule(mid_channels, out_channels, 1, act='ReLU',
                                bias=True, bn_eps=BN_EPS,
                                bn_momentum=BN_MOMENTUM)

    def forward(self, x):
        out = F.relu(self.bn2(self.conv2(self.conv1(x))))
        return self.conv3(out) + x


@NECKS.register_module()
class DilatedEncoder(nn.Module):
    """The keyword arguments are tpudet's fields
    (``channel_mapper.py:86-93``). ``forward`` takes the backbone's NCHW
    outputs (or one map) and returns a 1-tuple."""

    def __init__(self, in_channels: int = 2048, out_channels: int = 512,
                 block_mid_channels: int = 128, num_residual_blocks: int = 4,
                 block_dilations: Sequence[int] = (2, 4, 6, 8), dtype=None):
        super().__init__()
        _no_dtype('DilatedEncoder', dtype)
        self.lateral_conv = Conv(in_channels, out_channels, 1,
                                 kernel_init='xavier_uniform')
        self.lateral_norm = BatchNorm2d(out_channels, eps=BN_EPS,
                                        momentum=BN_MOMENTUM)
        self.fpn_conv = Conv(out_channels, out_channels, 3, 1, 1,
                             kernel_init='xavier_uniform')
        self.fpn_norm = BatchNorm2d(out_channels, eps=BN_EPS,
                                    momentum=BN_MOMENTUM)
        self.num_blocks = num_residual_blocks
        for i in range(num_residual_blocks):
            self.add_module(f'block{i}', DilatedBottleneck(
                out_channels, block_mid_channels, out_channels,
                block_dilations[i]))

    def forward(self, inputs):
        x = inputs[-1] if isinstance(inputs, (tuple, list)) else inputs
        x = self.fpn_norm(self.fpn_conv(self.lateral_norm(
            self.lateral_conv(x))))
        for i in range(self.num_blocks):
            x = getattr(self, f'block{i}')(x)
        return (x,)
