"""Shared conv/norm/act building blocks, port of ``tpudet/models/layers.py``.

Modules run NCHW (``channels_last`` memory on the card); the detector
takes and returns tpudet's NHWC layout at its surface. Attribute names
follow the flax names (``conv``, ``bn``), so weights map by name
(``utils/flax_import.py``). Inference only: BatchNorm uses its running
statistics.
"""
from __future__ import annotations

from typing import Callable, Optional, Union

import torch.nn.functional as F
from torch import nn

from ..ops.mish import mish_cuda

# the CSP family's BN convention (tpudet/models/layers.py:33, DARKNET_BN:
# eps 1e-3, flax decay 0.97 == torch momentum 0.03)
BN_EPS = 1e-3
BN_MOMENTUM = 0.03

ActCfg = Optional[Union[str, dict]]


def get_activation(act: ActCfg) -> Optional[Callable]:
    """Resolve an activation by the reference's config names. The ported
    slices use Mish only; the other names of tpudet come with the models
    that use them."""
    if act is None:
        return None
    name = act['type'] if isinstance(act, dict) else act
    if name.lower() == 'mish':
        return mish_cuda
    raise KeyError(f'activation {name} is not ported yet')


class Conv2d(nn.Module):
    """Raw bias-free 1x1 conv (the ``nn.Conv2d`` legs of CSP blocks); the
    torch conv is ``self.conv``, as flax names it."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, 1, bias=False)

    def forward(self, x):
        return self.conv(x)


class ConvModule(nn.Module):
    """conv (no bias) + BN + act (``tpudet/models/layers.py:63-104``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 1, stride: int = 1, act: ActCfg = 'Mish'):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size, stride,
                              kernel_size // 2, bias=False)
        self.bn = nn.BatchNorm2d(out_channels, eps=BN_EPS,
                                 momentum=BN_MOMENTUM)
        self.act = get_activation(act)

    def forward(self, x):
        x = self.bn(self.conv(x))
        return self.act(x) if self.act is not None else x


class BatchNormAct(nn.Module):
    """Shared BN + act over concatenated CSP branches
    (``tpudet/models/layers.py:130-147``)."""

    def __init__(self, channels: int, act: ActCfg = 'Mish'):
        super().__init__()
        self.bn = nn.BatchNorm2d(channels, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.act = get_activation(act)

    def forward(self, x):
        x = self.bn(x)
        return self.act(x) if self.act is not None else x


def max_pool_same(x, kernel_size: int):
    """Stride-1 max pool with same padding (SPP legs). Both frameworks pad
    with -inf, so this equals tpudet's separable form exactly."""
    return F.max_pool2d(x, kernel_size, 1, kernel_size // 2)


def upsample_nearest_2x(x):
    """Nearest-neighbour 2x upsample (neck top-down path)."""
    return F.interpolate(x, scale_factor=2, mode='nearest')
