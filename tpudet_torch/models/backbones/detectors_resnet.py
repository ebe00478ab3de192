"""DetectoRS ResNet: port of ``tpudet/models/backbones/detectors_resnet.py``
(``SAConv2d``, ``SACBottleneck``, ``DetectoRSResNet``,
``DetectoRSResNeXt``).

- ``SAConv2d``, switchable atrous convolution: the input plus a 1x1 conv
  of its spatial mean (``pre_context``); a per-pixel switch
  ``sigmoid(1x1(avgpool5(x)))`` (``switch``, at the conv's stride) blends
  one 3x3 kernel at dilation 1 with the kernel plus ``weight_diff`` at
  dilation 3; the output plus a 1x1 conv of its spatial mean
  (``post_context``). The kernel and ``weight_diff`` are the module's own
  parameters, tpudet's raw HWIO leaves ``kernel`` and ``weight_diff``
  (``flax_leaves``), and stay fp32: the two convolutions cast their input
  to the kernel's dtype and run in fp32 whatever the model's compute
  dtype (tpudet's ``x.astype(k.dtype)``), the 1x1 context convs in the
  compute dtype; the module returns fp32, which ``bn2`` normalises before
  its output takes the block's dtype. At tpudet's init ``pre_context``,
  ``post_context``, ``weight_diff`` and the switch's kernel are zero (the
  switch's bias 1);
- ``SACBottleneck``: ResNet's bottleneck with SAC as ``conv2`` (a plain
  3x3 where ``with_sac`` is off) and, in the first block of stages 2-4, a
  zero-init 1x1 ``rfp_conv`` that adds the RFP's feedback feature before
  the last ReLU (its bias alone when there is none);
- ``DetectoRSResNet``: the 7x7/2 stem (``conv1``, ``bn1``), a -inf-padded
  3x3/2 max-pool, ``sac_stages`` picking the SAC stages; ``forward(x,
  rfp_feats)`` feeds ``rfp_feats[i]`` to stage ``i`` > 0, and with
  ``output_img`` prepends the image (the RFP neck's second pass reads
  it). ``DetectoRSResNeXt`` groups the 3x3s (32 x 4d).

BatchNorm is tpudet's ``bn``: momentum 0.9 (torch 0.1), eps 1e-5.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.deform_conv import same_padding
from ...registry import BACKBONES
from ..layers import BatchNorm2d, Conv

ARCH = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


def _bn(channels):
    return BatchNorm2d(channels, eps=1e-5, momentum=0.1)


class SAConv2d(nn.Module):
    """``forward`` NCHW in the compute dtype -> NCHW fp32 (or wider)."""

    flax_leaves = {'weight': ('kernel', 'conv'),
                   'weight_diff': ('weight_diff', 'conv')}
    leaf_init = {'weight_diff': 'zeros'}

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 groups: int = 1):
        super().__init__()
        self.stride = stride
        self.groups = groups
        self.pre_context = Conv(in_channels, in_channels, 1,
                                kernel_init='zeros')
        self.switch = Conv(in_channels, 1, 1, kernel_init='zeros',
                           bias_init=1.)
        shape = (features, in_channels // groups, 3, 3)
        self.weight = nn.Parameter(torch.empty(shape))
        self.weight_diff = nn.Parameter(torch.zeros(shape))
        self.post_context = Conv(features, features, 1, kernel_init='zeros')

    def forward(self, x):
        dt = x.dtype
        x = x + self.pre_context(x.mean(dim=(2, 3), keepdim=True))
        switch = torch.sigmoid(self.switch(F.avg_pool2d(
            x, 5, self.stride, 2)))
        xk = x.to(self.weight.dtype)
        out = switch * F.conv2d(xk, self.weight, None, self.stride, 1, 1,
                                self.groups) + \
            (1 - switch) * F.conv2d(xk, self.weight + self.weight_diff, None,
                                    self.stride, 3, 3, self.groups)
        return out + self.post_context(out.mean(dim=(2, 3), keepdim=True)
                                       .to(dt))


class SACBottleneck(nn.Module):

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, with_sac: bool = True,
                 rfp: bool = False, rfp_inplanes: int = 256, groups: int = 1,
                 base_width: int = 4):
        super().__init__()
        width = planes if groups == 1 else int(
            planes * (base_width / 64.)) * groups
        self.conv1 = Conv(inplanes, width, 1, bias=False)
        self.bn1 = _bn(width)
        self.with_sac = with_sac
        self.stride = stride
        if with_sac:
            self.conv2 = SAConv2d(width, width, stride, groups)
        else:  # flax's 'SAME': (0, 1) at stride 2 on an even side
            self.conv2 = Conv(width, width, 3, stride, padding=0,
                              groups=groups, bias=False)
        self.bn2 = _bn(width)
        self.conv3 = Conv(width, planes * 4, 1, bias=False)
        self.bn3 = _bn(planes * 4)
        self.downsample = downsample
        if downsample:
            self.ds_conv = Conv(inplanes, planes * 4, 1, stride, bias=False)
            self.ds_bn = _bn(planes * 4)
        self.rfp = rfp
        if rfp:
            self.rfp_conv = Conv(rfp_inplanes, planes * 4, 1,
                                 kernel_init='zeros')

    def forward(self, x, rfp_feat=None):
        out = F.relu(self.bn1(self.conv1(x)))
        if not self.with_sac:
            (top, bottom), (left, right) = (same_padding(n, 3, self.stride)
                                            for n in out.shape[2:])
            out = F.pad(out, (left, right, top, bottom))
        out = self.conv2(out)  # fp32 from SAC; bn2 returns x's dtype
        out = self.bn2(out.to(torch.promote_types(x.dtype, out.dtype))
                       ).to(x.dtype)
        out = self.bn3(self.conv3(F.relu(out)))
        identity = self.ds_bn(self.ds_conv(x)) if self.downsample else x
        out = out + identity
        if self.rfp:
            if rfp_feat is None:  # tpudet's conv of zeros: its bias
                out = out + self.rfp_conv.bias.to(out.dtype)[:, None, None]
            else:
                out = out + self.rfp_conv(rfp_feat)
        return F.relu(out)


@BACKBONES.register_module()
class DetectoRSResNet(nn.Module):
    """``forward(x, rfp_feats=None)``: an NCHW image batch -> the
    ``out_indices`` stage outputs (the image first with
    ``output_img``)."""

    def __init__(self, depth: int = 50,
                 sac_stages: Sequence[bool] = (False, True, True, True),
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 output_img: bool = False, rfp_inplanes: int = 256,
                 groups: int = 1, base_width: int = 4, dtype=None):
        super().__init__()
        if dtype is not None:
            raise ValueError(f'DetectoRSResNet: dtype={dtype!r} is not a '
                             f'module setting in the port; see '
                             f'TwoStageDetector.set_dtype')
        if depth not in ARCH:
            raise KeyError(f'invalid depth {depth} for DetectoRSResNet')
        self.out_indices = tuple(out_indices)
        self.output_img = output_img
        self.conv1 = Conv(3, 64, 7, 2, 3, bias=False)
        self.bn1 = _bn(64)
        self.stage_names = []
        cin, planes = 64, 64
        for stage, n in enumerate(ARCH[depth]):
            names = []
            for i in range(n):
                name = f'layer{stage + 1}_{i}'
                self.add_module(name, SACBottleneck(
                    cin, planes, stride=(1 if stage == 0 else 2) if i == 0
                    else 1, downsample=i == 0,
                    with_sac=bool(sac_stages[stage]),
                    rfp=stage > 0 and i == 0, rfp_inplanes=rfp_inplanes,
                    groups=groups, base_width=base_width))
                names.append(name)
                cin = planes * 4
            self.stage_names.append(names)
            planes *= 2

    def forward(self, x, rfp_feats: Optional[Sequence] = None):
        img = x
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        outs = []
        for stage, names in enumerate(self.stage_names):
            feed = (None if rfp_feats is None or stage == 0
                    else rfp_feats[stage])
            for i, name in enumerate(names):
                x = getattr(self, name)(x, feed if i == 0 else None)
            if stage in self.out_indices:
                outs.append(x)
        return ((img,) if self.output_img else ()) + tuple(outs)


@BACKBONES.register_module()
class DetectoRSResNeXt(DetectoRSResNet):
    """Grouped bottlenecks; the defaults are the x101-32x4d configs'."""

    def __init__(self, groups: int = 32, base_width: int = 4, **kwargs):
        super().__init__(groups=groups, base_width=base_width, **kwargs)
