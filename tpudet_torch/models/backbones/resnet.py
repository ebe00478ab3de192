"""ResNet and ResNeXt backbones: port of
``tpudet/models/backbones/resnet.py:67-247`` (``BasicBlock``,
``Bottleneck``, ``ResNet``, ``ResNeXt``).

The depth table of the reference: ``BasicBlock`` for 18/34,
``Bottleneck`` for 50/101/152, the stride on the 3x3 (``style='pytorch'``),
a 7x7/2 stem conv, a norm, ReLU and a 3x3/2 max-pool that pads with -inf
(as flax's ``max_pool``). Convs are bias-free ``he_normal``; the norm is
``layers.BatchNorm2d`` with tpudet's momentum 0.9 (torch 0.1), eps 1e-5
and flax's biased running variance, or with ``norm='GN'`` the port's
``GroupNorm`` (``gn_groups`` groups, no running statistics: tpudet's
``frozen_stages`` does not exist for this backbone, and train and eval
mode compute the same). ``conv_ws=True`` makes every conv a ``WSConv``,
the stem and the downsample branch included; as in tpudet, ResNeXt's
weight-standardized 3x3 is not grouped (``resnet.py:31-40, 123-124``).
Module names are tpudet's (``stem_conv``, ``layer{i}_{j}.conv1``,
``ds_conv``, ...), so weights carry by name. DCN and plugins raise.
"""
from __future__ import annotations

from typing import Sequence

import torch.nn.functional as F
from torch import nn

from ...registry import BACKBONES
from ..layers import Conv
from ..plugins import WSConv, make_norm

BN_MOMENTUM = 0.1  # flax 0.9
BN_EPS = 1e-5


class _Convs:
    """tpudet's conv factory and norm of a block: ``conv(cin, cout,
    kernel, stride, groups)`` plain ``he_normal`` or weight-standardized
    (which takes no groups, as tpudet's ``_make_conv``), ``norm(c)`` BN
    or GN."""

    def __init__(self, norm: str = 'BN', gn_groups: int = 32,
                 conv_ws: bool = False):
        self.norm_type, self.gn_groups, self.conv_ws = norm, gn_groups, conv_ws

    def conv(self, cin, cout, kernel, stride=1, groups=1):
        if self.conv_ws:
            return WSConv(cin, cout, kernel, stride)
        return Conv(cin, cout, kernel, stride, kernel // 2, groups=groups,
                    bias=False)

    def norm(self, channels):
        return make_norm(self.norm_type, channels, self.gn_groups, BN_EPS,
                         BN_MOMENTUM)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, convs: _Convs = _Convs()):
        super().__init__()
        self.conv1 = convs.conv(inplanes, planes, 3, stride)
        self.bn1 = convs.norm(planes)
        self.conv2 = convs.conv(planes, planes, 3)
        self.bn2 = convs.norm(planes)
        if downsample:
            self.ds_conv = convs.conv(inplanes, planes, 1, stride)
            self.ds_bn = convs.norm(planes)
        self.downsample = downsample

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = self.ds_bn(self.ds_conv(x)) if self.downsample else x
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    """1x1, 3x3 (grouped for ResNeXt: width ``int(planes * base_width /
    64) * groups``), 1x1 to ``planes * 4``."""
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, groups: int = 1,
                 base_width: int = 64, convs: _Convs = _Convs()):
        super().__init__()
        width = planes if groups == 1 else int(
            planes * (base_width / 64)) * groups
        self.conv1 = convs.conv(inplanes, width, 1)
        self.bn1 = convs.norm(width)
        self.conv2 = convs.conv(width, width, 3, stride, groups=groups)
        self.bn2 = convs.norm(width)
        self.conv3 = convs.conv(width, planes * self.expansion, 1)
        self.bn3 = convs.norm(planes * self.expansion)
        if downsample:
            self.ds_conv = convs.conv(inplanes, planes * self.expansion, 1,
                                      stride)
            self.ds_bn = convs.norm(planes * self.expansion)
        self.downsample = downsample

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = self.ds_bn(self.ds_conv(x)) if self.downsample else x
        return F.relu(out + identity)


def _refuse(name, value, default):
    if value != default and value is not None:
        raise NotImplementedError(
            f'ResNet({name}={value!r}) is not ported; it comes with '
            f'ROADMAP.md\'s "rest of the zoo" item')


@BACKBONES.register_module()
class ResNet(nn.Module):
    """``forward`` takes an NCHW image batch and returns the
    ``out_indices`` stage outputs, NCHW."""

    arch_settings = {
        18: (BasicBlock, (2, 2, 2, 2)),
        34: (BasicBlock, (3, 4, 6, 3)),
        50: (Bottleneck, (3, 4, 6, 3)),
        101: (Bottleneck, (3, 4, 23, 3)),
        152: (Bottleneck, (3, 8, 36, 3)),
    }

    def __init__(self, depth: int = 50,
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 base_channels: int = 64, groups: int = 1,
                 base_width: int = 64,
                 stage_with_dcn: Sequence[bool] = (False,) * 4,
                 norm: str = 'BN', gn_groups: int = 32,
                 conv_ws: bool = False, plugins=None, dtype=None):
        super().__init__()
        if depth not in self.arch_settings:
            raise KeyError(f'invalid depth {depth} for ResNet')
        if any(stage_with_dcn):
            _refuse('stage_with_dcn', tuple(stage_with_dcn), ())
        _refuse('plugins', plugins or None, None)
        if dtype is not None:  # tpudet's module field
            raise ValueError(
                f'ResNet: dtype={dtype!r} is not a module setting in the '
                f'port; set the compute dtype on the detector with '
                f'SingleStageDetector.set_dtype (init_detector(dtype=...)) '
                f"or the config's compute_dtype for training")
        self.depth = depth
        self.out_indices = tuple(out_indices)
        block_cls, stage_blocks = self.arch_settings[depth]
        convs = _Convs(norm, gn_groups, conv_ws)
        self.stem_conv = (WSConv(3, base_channels, 7, 2) if conv_ws else
                          Conv(3, base_channels, 7, 2, 3, bias=False))
        self.stem_bn = convs.norm(base_channels)
        self.stage_names = []
        cin = base_channels
        kw = dict(convs=convs)
        if block_cls is Bottleneck:
            kw.update(groups=groups, base_width=base_width)
        for i, num_blocks in enumerate(stage_blocks):
            planes = base_channels * 2**i
            names = []
            for j in range(num_blocks):
                stride = 2 if (i > 0 and j == 0) else 1
                cout = planes * block_cls.expansion
                needs_ds = j == 0 and (stride != 1 or cin != cout)
                name = f'layer{i + 1}_{j}'
                self.add_module(name, block_cls(cin, planes, stride,
                                                needs_ds, **kw))
                names.append(name)
                cin = cout
            self.stage_names.append(names)

    @classmethod
    def out_channels(cls, depth, out_indices):
        block, _ = cls.arch_settings[depth]
        return tuple(64 * 2**i * block.expansion for i in out_indices)

    def forward(self, x):
        x = F.relu(self.stem_bn(self.stem_conv(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        outs = []
        for i, names in enumerate(self.stage_names):
            for name in names:
                x = getattr(self, name)(x)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)


@BACKBONES.register_module()
class ResNeXt(ResNet):
    """Grouped bottlenecks, e.g. depth 101, groups 32, base_width 4."""

    def __init__(self, depth: int = 50, groups: int = 32,
                 base_width: int = 4, **kwargs):
        super().__init__(depth=depth, groups=groups, base_width=base_width,
                         **kwargs)
