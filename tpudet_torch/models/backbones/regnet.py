"""RegNet backbone: port of ``tpudet/models/backbones/regnet.py``
(``generate_regnet``, ``adjust_width_group``, ``RegBottleneck``,
``RegNet`` with tpudet's ``ARCHS``).

Stage widths and depths come from the quantised linear parameterisation
``(w0, wa, wm, depth)``, each width made a multiple of its group width.
A stage's first block takes stride 2 and a 1x1 downsample branch; every
block is a bottleneck of ratio 1: 1x1, a grouped 3x3 (``groups = width //
group_width``), 1x1, each with ResNet's BatchNorm (eps 1e-5, flax
momentum 0.9) and ReLU after the sum. The stem is a 3x3/2 conv of 32
channels. Convs are bias-free ``he_normal``. Module names are tpudet's
(``stem_conv``, ``stage{i}_block{j}.conv1``, ``ds_conv``, ...).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch.nn.functional as F
from torch import nn

from ...registry import BACKBONES
from ..layers import BatchNorm2d, Conv
from .resnet import BN_EPS, BN_MOMENTUM


def generate_regnet(w0: float, wa: float, wm: float, depth: int,
                    q: int = 8) -> Tuple[list, list]:
    """Per-block widths -> (stage_widths, stage_depths)."""
    ws_cont = w0 + wa * np.arange(depth)
    ks = np.round(np.log(ws_cont / w0) / np.log(wm))
    widths = w0 * np.power(wm, ks)
    widths = (np.round(widths / q) * q).astype(int)
    stage_widths, stage_depths = [], []
    for w in widths:
        if not stage_widths or stage_widths[-1] != w:
            stage_widths.append(int(w))
            stage_depths.append(1)
        else:
            stage_depths[-1] += 1
    return stage_widths, stage_depths


def adjust_width_group(widths, groups):
    """Widths divisible by their group widths."""
    out_w, out_g = [], []
    for w in widths:
        g = min(groups, w)
        w = int(round(w / g) * g)
        out_w.append(w)
        out_g.append(g)
    return out_w, out_g


def _bn(channels):
    return BatchNorm2d(channels, eps=BN_EPS, momentum=BN_MOMENTUM)


class RegBottleneck(nn.Module):

    def __init__(self, inplanes: int, width: int, stride: int,
                 group_width: int, downsample: bool):
        super().__init__()
        groups = max(width // group_width, 1)
        self.conv1 = Conv(inplanes, width, 1, bias=False)
        self.bn1 = _bn(width)
        self.conv2 = Conv(width, width, 3, stride, 1, groups=groups,
                          bias=False)
        self.bn2 = _bn(width)
        self.conv3 = Conv(width, width, 1, bias=False)
        self.bn3 = _bn(width)
        if downsample:
            self.ds_conv = Conv(inplanes, width, 1, stride, bias=False)
            self.ds_bn = _bn(width)
        self.downsample = downsample

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = self.ds_bn(self.ds_conv(x)) if self.downsample else x
        return F.relu(out + identity)


@BACKBONES.register_module()
class RegNet(nn.Module):
    """``forward`` takes an NCHW image batch and returns the
    ``out_indices`` stage outputs, NCHW."""

    ARCHS = {
        'regnetx_400mf': dict(w0=24, wa=24.48, wm=2.54, group_w=16,
                              depth=22),
        'regnetx_800mf': dict(w0=56, wa=35.73, wm=2.28, group_w=16,
                              depth=16),
        'regnetx_1.6gf': dict(w0=80, wa=34.01, wm=2.25, group_w=24,
                              depth=18),
        'regnetx_3.2gf': dict(w0=88, wa=26.31, wm=2.25, group_w=48,
                              depth=25),
        'regnetx_4.0gf': dict(w0=96, wa=38.65, wm=2.43, group_w=40,
                              depth=23),
        'regnetx_6.4gf': dict(w0=184, wa=60.83, wm=2.07, group_w=56,
                              depth=17),
        'regnetx_8.0gf': dict(w0=80, wa=49.56, wm=2.88, group_w=120,
                              depth=23),
        'regnetx_12gf': dict(w0=168, wa=73.36, wm=2.37, group_w=112,
                             depth=19),
    }

    @classmethod
    def stage_config(cls, arch: str):
        p = cls.ARCHS[arch]
        widths, depths = generate_regnet(p['w0'], p['wa'], p['wm'],
                                         p['depth'])
        widths, groups = adjust_width_group(widths, p['group_w'])
        return widths, depths, groups

    @classmethod
    def out_channels(cls, arch, out_indices):
        widths, _, _ = cls.stage_config(arch)
        return tuple(widths[i] for i in out_indices)

    def __init__(self, arch: str = 'regnetx_3.2gf',
                 out_indices: Sequence[int] = (0, 1, 2, 3), dtype=None):
        super().__init__()
        if dtype is not None:  # tpudet's module field
            raise ValueError(
                f'RegNet: dtype={dtype!r} is not a module setting in the '
                f'port; set the compute dtype on the detector '
                f'(SingleStageDetector.set_dtype)')
        self.out_indices = tuple(out_indices)
        widths, depths, groups = self.stage_config(arch)
        self.stem_conv = Conv(3, 32, 3, 2, 1, bias=False)
        self.stem_bn = _bn(32)
        self.stage_names = []
        cin = 32
        for i, (w, d, g) in enumerate(zip(widths, depths, groups)):
            names = []
            for j in range(d):
                name = f'stage{i + 1}_block{j}'
                self.add_module(name, RegBottleneck(
                    cin, w, 2 if j == 0 else 1, g, j == 0))
                names.append(name)
                cin = w
            self.stage_names.append(names)

    def forward(self, x):
        x = F.relu(self.stem_bn(self.stem_conv(x)))
        outs = []
        for i, names in enumerate(self.stage_names):
            for name in names:
                x = getattr(self, name)(x)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)
