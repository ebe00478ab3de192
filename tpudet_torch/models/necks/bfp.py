"""Libra R-CNN's balanced feature pyramid: port of ``BFP`` and its
``NonLocal2d`` (``tpudet/models/necks/hrfpn.py:87-147``), with
``_pool_to`` and ``_resize_nearest`` (``:23-47``).

Every level is brought to the refine level's size (max-pooled down from
the finer levels, repeated up from the coarser ones, both by exact integer
ratios), the levels are averaged, refined (a 3x3 conv, or the
embedded-gaussian non-local block), and scattered back: each level adds
the refined map brought to its own size (repeated up to the finer levels,
max-pooled down to the coarser ones). Sizes that are not integer ratios
raise, as tpudet asserts.

``NonLocal2d`` is a submodule of the neck, not a plugin: ``g``, ``theta``
and ``phi`` 1x1 convs drawn N(0, 0.01^2), the (B, HW, HW) energies of
``theta`` against ``phi`` (no scale), a softmax over the keys, the
weighted sum of ``g``, then ``conv_out`` (zero at tpudet's init, so the
block starts as the identity) added to the input. The energies are
materialised in the input's dtype, as tpudet's ``einsum`` does.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...registry import NECKS
from ..layers import Conv


def pool_to(x: torch.Tensor, size) -> torch.Tensor:
    """NCHW max-pool down to ``size`` by an exact integer ratio."""
    h, w = x.shape[2:]
    th, tw = size
    if (th, tw) == (h, w):
        return x
    if h % th or w % tw:
        raise ValueError(f'{tuple(x.shape)} does not pool to {size} by an '
                         f'integer ratio')
    k = (h // th, w // tw)
    return F.max_pool2d(x, k, stride=k)


def resize_nearest(x: torch.Tensor, size) -> torch.Tensor:
    """NCHW nearest resize up to ``size`` by an exact integer ratio: each
    pixel repeated ``th / h`` x ``tw / w`` times."""
    b, c, h, w = x.shape
    th, tw = size
    if (th, tw) == (h, w):
        return x
    if th % h or tw % w:
        raise ValueError(f'{tuple(x.shape)} does not resize to {size} by '
                         f'an integer ratio')
    ry, rx = th // h, tw // w
    return x[:, :, :, None, :, None].expand(b, c, h, ry, w, rx).reshape(
        b, c, th, tw)


class NonLocal2d(nn.Module):
    """mmcv's embedded-gaussian ``NonLocal2d`` as tpudet's BFP builds it:
    ``reduction`` 1 (the inner width is the input's), no scale on the
    energies."""

    def __init__(self, channels: int):
        super().__init__()
        for name in ('g', 'theta', 'phi'):
            self.add_module(name, Conv(channels, channels, 1,
                                       kernel_init=('normal', 0.01)))
        self.conv_out = Conv(channels, channels, 1, kernel_init='zeros')

    def forward(self, x):
        b, c, h, w = x.shape

        def rows(conv):  # (B, HW, C)
            return conv(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        g, theta, phi = rows(self.g), rows(self.theta), rows(self.phi)
        attn = F.softmax(torch.bmm(theta, phi.transpose(1, 2)), dim=-1)
        y = torch.bmm(attn, g).reshape(b, h, w, c).permute(
            0, 3, 1, 2)  # a channels-last view
        return x + self.conv_out(y)


@NECKS.register_module()
class BFP(nn.Module):
    """The keyword arguments are tpudet's fields (``hrfpn.py:122-127``).
    ``forward`` takes ``num_levels`` NCHW maps and returns as many."""

    def __init__(self, in_channels: int = 256, num_levels: int = 5,
                 refine_level: int = 2, refine_type: Optional[str] = None,
                 dtype=None):
        super().__init__()
        if dtype is not None:
            raise ValueError(f'BFP: dtype={dtype!r} is not a module setting '
                             f'in the port; see the detector\'s set_dtype')
        if refine_type not in (None, 'conv', 'non_local'):
            raise ValueError(f'BFP: unknown refine_type {refine_type!r}')
        self.num_levels = num_levels
        self.refine_level = refine_level
        self.refine_type = refine_type
        if refine_type == 'conv':
            self.refine = Conv(in_channels, in_channels, 3, 1, 1,
                               kernel_init='xavier_uniform')
        elif refine_type == 'non_local':
            self.refine = NonLocal2d(in_channels)

    def forward(self, inputs):
        assert len(inputs) == self.num_levels
        size = inputs[self.refine_level].shape[2:]
        feats = [pool_to(x, size) if i < self.refine_level
                 else resize_nearest(x, size) for i, x in enumerate(inputs)]
        bsf = sum(feats) / len(feats)
        if self.refine_type is not None:
            bsf = self.refine(bsf)
        return tuple(
            x + (resize_nearest(bsf, x.shape[2:]) if i < self.refine_level
                 else pool_to(bsf, x.shape[2:]))
            for i, x in enumerate(inputs))
