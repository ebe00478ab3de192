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
``ds_conv``, ...), so weights carry by name.

``stage_with_dcn`` makes a stage's ``Bottleneck.conv2`` a
``ModulatedDeformConv2d`` (``ops/deform_conv.py``, no bias, named
``conv2``; it returns fp32, which ``bn2`` normalises before its output
takes the block's dtype, as flax's BatchNorm does with ``dtype``). DCN on
a grouped (ResNeXt) block raises, as tpudet asserts. ``plugins`` (a list
of ``dict(cfg=dict(type=...), stages=(bool,) * 4, position=...)``) put a
``plugins.build_plugin`` module after ``conv1``/``bn1``+ReLU, after
``conv2``/``bn2``+ReLU (``after_conv2``) or after ``conv3``/``bn3``,
before the residual sum, in every block of the stages it names; a
module is ``plugin_{position}_{i}``, ``i`` its index in the stage's
filtered list (tpudet's ``_apply_plugins``, ``resnet.py:53-64``).
``BasicBlock`` takes ``after_conv1`` and ``after_conv2`` plugins.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.deform_conv import ModulatedDeformConv2d
from ...registry import BACKBONES
from ..layers import Conv
from ..plugins import WSConv, build_plugin, make_norm

POSITIONS = ('after_conv1', 'after_conv2', 'after_conv3')

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


class _PluginBlock(nn.Module):
    """A block's plugins: ``add_plugins`` builds them, ``plugins(x,
    position)`` applies those at ``position`` in order."""

    def add_plugins(self, plugins, channels):
        """``plugins``: the stage's filtered list; ``channels``: position
        -> the channels there."""
        self.plugin_names = {pos: [] for pos in POSITIONS}
        for i, p in enumerate(plugins or ()):
            pos = p.get('position', 'after_conv3')
            if pos not in channels:
                continue
            name = f'plugin_{pos}_{i}'
            self.add_module(name, build_plugin(p['cfg'] if 'cfg' in p else p,
                                               channels[pos]))
            self.plugin_names[pos].append(name)

    def plugins(self, x, position):
        for name in self.plugin_names[position]:
            x = getattr(self, name)(x)
        return x


class BasicBlock(_PluginBlock):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, convs: _Convs = _Convs(),
                 plugins=None):
        super().__init__()
        self.conv1 = convs.conv(inplanes, planes, 3, stride)
        self.bn1 = convs.norm(planes)
        self.conv2 = convs.conv(planes, planes, 3)
        self.bn2 = convs.norm(planes)
        if downsample:
            self.ds_conv = convs.conv(inplanes, planes, 1, stride)
            self.ds_bn = convs.norm(planes)
        self.downsample = downsample
        self.add_plugins(plugins, {'after_conv1': planes,
                                   'after_conv2': planes})

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.plugins(out, 'after_conv1')
        out = self.plugins(self.bn2(self.conv2(out)), 'after_conv2')
        identity = self.ds_bn(self.ds_conv(x)) if self.downsample else x
        return F.relu(out + identity)


class Bottleneck(_PluginBlock):
    """1x1, 3x3 (grouped for ResNeXt: width ``int(planes * base_width /
    64) * groups``; deformable with ``with_dcn``), 1x1 to ``planes * 4``."""
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, groups: int = 1,
                 base_width: int = 64, convs: _Convs = _Convs(),
                 with_dcn: bool = False, plugins=None):
        super().__init__()
        width = planes if groups == 1 else int(
            planes * (base_width / 64)) * groups
        self.conv1 = convs.conv(inplanes, width, 1)
        self.bn1 = convs.norm(width)
        if with_dcn:
            if groups != 1:
                raise NotImplementedError(
                    'DCN + grouped conv not supported (ResNeXt with '
                    'stage_with_dcn; tpudet asserts it at '
                    'tpudet/models/backbones/resnet.py:131)')
            self.conv2 = ModulatedDeformConv2d(width, width, 3, stride,
                                               bias=False)
        else:
            self.conv2 = convs.conv(width, width, 3, stride, groups=groups)
        self.bn2 = convs.norm(width)
        self.conv3 = convs.conv(width, planes * self.expansion, 1)
        self.bn3 = convs.norm(planes * self.expansion)
        if downsample:
            self.ds_conv = convs.conv(inplanes, planes * self.expansion, 1,
                                      stride)
            self.ds_bn = convs.norm(planes * self.expansion)
        self.downsample = downsample
        self.add_plugins(plugins, {'after_conv1': width,
                                   'after_conv2': width,
                                   'after_conv3': planes * self.expansion})

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.plugins(out, 'after_conv1')
        out = self.conv2(out)  # fp32 from a DCN; bn2 returns x's dtype
        out = self.bn2(out.to(torch.promote_types(x.dtype, out.dtype))
                       ).to(x.dtype)
        out = self.plugins(F.relu(out), 'after_conv2')
        out = self.plugins(self.bn3(self.conv3(out)), 'after_conv3')
        identity = self.ds_bn(self.ds_conv(x)) if self.downsample else x
        return F.relu(out + identity)


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
            stage_kw = dict(kw, plugins=[
                p for p in plugins or () if p.get('stages', (True,) * 4)[i]])
            if block_cls is Bottleneck:
                stage_kw['with_dcn'] = bool(stage_with_dcn[i])
            for j in range(num_blocks):
                stride = 2 if (i > 0 and j == 0) else 1
                cout = planes * block_cls.expansion
                needs_ds = j == 0 and (stride != 1 or cin != cout)
                name = f'layer{i + 1}_{j}'
                self.add_module(name, block_cls(cin, planes, stride,
                                                needs_ds, **stage_kw))
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
