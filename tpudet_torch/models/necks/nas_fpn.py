"""NAS-FPN: port of ``tpudet/models/necks/nas_fpn.py`` (``SumCell``,
``GlobalPoolingCell``, ``NASFPN``).

1x1 ``lateral_conv{i}`` from ``start_level`` (biased, ``xavier_uniform``)
and the extra levels as a 1x1 ``extra_conv{i}`` then a 2x2 stride-2
max-pool (floor) of the last level; then ``stack_times`` stacks of the
searched merge cells ``s{s}_gp_64_4`` ... ``s{s}_gp_75_6``. A cell brings
both inputs to its output size (``fit``: repeated up or max-pooled down by
an exact integer ratio, ``necks/bfp.py``'s ``resize_nearest`` and
``pool_to``, as tpudet's ``_fit`` asserts) and sums them (``SumCell``),
or adds ``sigmoid(mean over H, W of x2) * x1`` to ``x2``
(``GlobalPoolingCell``); a cell with an out conv then applies ReLU and a
3x3 ``out.conv`` (biased, ``xavier_uniform``). The topology is defined
for 5 levels.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...registry import NECKS
from ..layers import Conv
from .bfp import pool_to, resize_nearest


def fit(x: torch.Tensor, size) -> torch.Tensor:
    """tpudet's ``_fit`` on NCHW: up by repetition when the height does not
    shrink, else max-pooled down; integer ratios only."""
    if tuple(x.shape[2:]) == tuple(size):
        return x
    if x.shape[2] <= size[0]:
        return resize_nearest(x, size)
    return pool_to(x, size)


class _OutConv(nn.Module):
    """mmcv's merge-cell out conv as tpudet builds it: ReLU, then a 3x3
    ``conv``."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv(channels, channels, 3, 1, 1,
                         kernel_init='xavier_uniform')

    def forward(self, x):
        return self.conv(F.relu(x))


class SumCell(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.out = _OutConv(channels)

    def forward(self, x1, x2, size):
        return self.out(fit(x1, size) + fit(x2, size))


class GlobalPoolingCell(nn.Module):
    def __init__(self, channels: int, with_out_conv: bool = True):
        super().__init__()
        self.out = _OutConv(channels) if with_out_conv else None

    def forward(self, x1, x2, size):
        x1, x2 = fit(x1, size), fit(x2, size)
        x = torch.sigmoid(x2.mean(dim=(2, 3), keepdim=True)) * x1 + x2
        return x if self.out is None else self.out(x)


# (cell, kind, with an out conv) of one stack, in tpudet's order
CELLS = (('gp_64_4', 'gp', True), ('sum_44_4', 'sum', True),
         ('sum_43_3', 'sum', True), ('sum_34_4', 'sum', True),
         ('gp_43_5', 'gp', False), ('sum_55_5', 'sum', True),
         ('gp_54_7', 'gp', False), ('sum_77_7', 'sum', True),
         ('gp_75_6', 'gp', True))


@NECKS.register_module()
class NASFPN(nn.Module):
    """The keyword arguments are tpudet's fields (``nas_fpn.py:73-79``).
    ``forward`` takes the backbone's NCHW outputs and returns P3-P7."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 num_outs: int = 5, stack_times: int = 7,
                 start_level: int = 0, dtype=None):
        super().__init__()
        if dtype is not None:
            raise ValueError(f'NASFPN: dtype={dtype!r} is not a module '
                             f'setting in the port; see the detector\'s '
                             f'set_dtype')
        self.in_channels = tuple(in_channels)
        self.start_level = start_level
        self.used = len(self.in_channels) - start_level
        self.extra = num_outs - self.used
        if num_outs != 5:
            raise ValueError('NAS-FPN topology is defined for 5 levels')
        self.stack_times = stack_times
        c = out_channels
        for i in range(self.used):
            self.add_module(f'lateral_conv{i}', Conv(
                self.in_channels[start_level + i], c, 1,
                kernel_init='xavier_uniform'))
        for i in range(self.extra):
            self.add_module(f'extra_conv{i}', Conv(
                c, c, 1, kernel_init='xavier_uniform'))
        for s in range(stack_times):
            for name, kind, out in CELLS:
                self.add_module(f's{s}_{name}', SumCell(c) if kind == 'sum'
                                else GlobalPoolingCell(c, out))

    def forward(self, inputs):
        feats = [getattr(self, f'lateral_conv{i}')(
            inputs[self.start_level + i]) for i in range(self.used)]
        for i in range(self.extra):
            feats.append(F.max_pool2d(
                getattr(self, f'extra_conv{i}')(feats[-1]), 2, 2))
        p3, p4, p5, p6, p7 = feats

        def sz(p):
            return tuple(p.shape[2:])
        for s in range(self.stack_times):
            def cell(name):
                return getattr(self, f's{s}_{name}')
            p4_1 = cell('gp_64_4')(p6, p4, sz(p4))
            p4_2 = cell('sum_44_4')(p4_1, p4, sz(p4))
            p3 = cell('sum_43_3')(p4_2, p3, sz(p3))
            p4 = cell('sum_34_4')(p3, p4_2, sz(p4))
            p5_tmp = cell('gp_43_5')(p4, p3, sz(p5))
            p5 = cell('sum_55_5')(p5, p5_tmp, sz(p5))
            p7_tmp = cell('gp_54_7')(p5, p4_2, sz(p7))
            p7 = cell('sum_77_7')(p7, p7_tmp, sz(p7))
            p6 = cell('gp_75_6')(p7, p5, sz(p6))
        return p3, p4, p5, p6, p7
