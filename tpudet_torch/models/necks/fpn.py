"""FPN neck: port of ``tpudet/models/necks/fpn.py:27-84``.

Lateral 1x1 convs from ``start_level`` on, a nearest 2x top-down merge,
3x3 output convs, and ``num_outs - used`` extra levels: 1x1/2 max-pools
(``add_extra_convs=False``) or stride-2 3x3 convs on the last input
(``'on_input'``) or the last output (``'on_output'``, or ``True`` as
tpudet reads it), with a ReLU before every extra conv but the first when
``relu_before_extra_convs``. Every conv has a bias and tpudet's
``xavier_uniform`` init. GN raises.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch.nn.functional as F
from torch import nn

from ...registry import NECKS
from ..layers import Conv, upsample_nearest_2x


def _conv(cin, cout, kernel, stride=1):
    return Conv(cin, cout, kernel, stride, kernel // 2,
                kernel_init='xavier_uniform')


@NECKS.register_module()
class FPN(nn.Module):
    """``forward`` takes the backbone's NCHW outputs and returns
    ``num_outs`` NCHW levels."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 num_outs: int = 5, start_level: int = 0,
                 add_extra_convs: Union[bool, str] = False,
                 relu_before_extra_convs: bool = False,
                 norm: Optional[str] = None, gn_groups: int = 32,
                 dtype=None):
        super().__init__()
        if norm is not None:
            raise NotImplementedError(
                f'FPN(norm={norm!r}) is not ported; it comes with '
                f'ROADMAP.md\'s "rest of the zoo" item')
        if dtype is not None:
            raise ValueError(f'FPN: dtype={dtype!r} is not a module setting '
                             f'in the port; see SingleStageDetector.set_dtype')
        self.in_channels = tuple(in_channels)
        self.start_level = start_level
        self.add_extra_convs = add_extra_convs
        self.relu_before_extra_convs = relu_before_extra_convs
        self.used = len(self.in_channels) - start_level
        self.extra = num_outs - self.used
        for i in range(self.used):
            self.add_module(f'lateral_conv{i}', _conv(
                self.in_channels[start_level + i], out_channels, 1))
            self.add_module(f'fpn_conv{i}', _conv(out_channels,
                                                  out_channels, 3))
        if add_extra_convs:
            cin = (self.in_channels[-1] if add_extra_convs == 'on_input'
                   else out_channels)
            for i in range(self.extra):
                self.add_module(f'extra_conv{i}', _conv(cin, out_channels, 3,
                                                        2))
                cin = out_channels

    def forward(self, inputs):
        assert len(inputs) == len(self.in_channels)
        laterals = [getattr(self, f'lateral_conv{i}')(
            inputs[self.start_level + i]) for i in range(self.used)]
        for i in range(self.used - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + upsample_nearest_2x(
                laterals[i])
        outs = [getattr(self, f'fpn_conv{i}')(laterals[i])
                for i in range(self.used)]
        if self.extra > 0:
            if not self.add_extra_convs:
                for _ in range(self.extra):
                    outs.append(F.max_pool2d(outs[-1], 1, 2))
            else:
                src = (inputs[-1] if self.add_extra_convs == 'on_input'
                       else outs[-1])
                for i in range(self.extra):
                    if i > 0 and self.relu_before_extra_convs:
                        src = F.relu(src)
                    src = getattr(self, f'extra_conv{i}')(src)
                    outs.append(src)
        return tuple(outs)
