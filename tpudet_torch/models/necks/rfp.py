"""Recursive Feature Pyramid: port of ``tpudet/models/necks/rfp.py``
(``ASPP``, ``RFP``).

The input is the DetectoRS backbone's ``(image, C2..C5)``. One FPN
(``fpn``) makes the first pyramid; each further step feeds levels 1-3 of
the last pyramid through one ASPP (``rfp_aspp``: 3x3 convs at dilations
1, 3, 6 and a 1x1 of the spatial mean, each ReLU'd, concatenated) into a
second backbone (``rfp_module{i}``, built by name from ``rfp_backbone``
through the port's registry, with weights of its own) run on the image
again; the same FPN turns its stages into a new pyramid, and each level
is blended with the last one by a sigmoid gate, one 1x1 conv for every
level (``rfp_weight``, zero at tpudet's init: 0.5 / 0.5). tpudet also
feeds the ASPP the first and the last level, which the backbone never
reads; the port skips them.
"""
from __future__ import annotations

import copy
from typing import Dict, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ...registry import MODELS, NECKS, build_from_cfg
from ..layers import Conv
from .fpn import FPN


class ASPP(nn.Module):
    """NCHW (B, C, H, W) -> (B, 4 x out_channels, H, W)."""

    def __init__(self, in_channels: int, out_channels: int = 64,
                 dilations: Sequence[int] = (1, 3, 6, 1)):
        super().__init__()
        self.dilations = tuple(dilations)
        last = len(self.dilations) - 1
        for i, d in enumerate(self.dilations):
            k = 1 if i == last else 3
            self.add_module(f'aspp{i}', Conv(
                in_channels, out_channels, k,
                padding=0 if i == last else d, dilation=d))

    def forward(self, x):
        gap = x.mean(dim=(2, 3), keepdim=True)
        last = len(self.dilations) - 1
        outs = [F.relu(getattr(self, f'aspp{i}')(gap if i == last else x))
                for i in range(len(self.dilations))]
        outs[-1] = outs[-1].expand_as(outs[-2])
        return torch.cat(outs, dim=1)


@NECKS.register_module()
class RFP(nn.Module):
    """The keyword arguments are tpudet's fields (``rfp.py:58-68``)."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 num_outs: int = 5, start_level: int = 0,
                 add_extra_convs: Union[bool, str] = False,
                 rfp_steps: int = 2, rfp_backbone: Optional[Dict] = None,
                 aspp_out_channels: int = 64,
                 aspp_dilations: Sequence[int] = (1, 3, 6, 1), dtype=None):
        super().__init__()
        if dtype is not None:
            raise ValueError(f'RFP: dtype={dtype!r} is not a module setting '
                             f'in the port; see TwoStageDetector.set_dtype')
        self.rfp_steps = rfp_steps
        self.fpn = FPN(in_channels, out_channels, num_outs, start_level,
                       add_extra_convs)
        self.rfp_aspp = ASPP(out_channels, aspp_out_channels, aspp_dilations)
        self.rfp_weight = Conv(out_channels, 1, 1, kernel_init='zeros')
        for step in range(1, rfp_steps):
            cfg = dict(copy.deepcopy(dict(rfp_backbone)), output_img=False)
            self.add_module(f'rfp_module{step - 1}',
                            build_from_cfg(cfg, MODELS))

    def forward(self, inputs):
        img, feats = inputs[0], tuple(inputs[1:])
        x = self.fpn(feats)
        for step in range(1, self.rfp_steps):
            rfp_feats = [None] + [self.rfp_aspp(x[i]) for i in range(1, 4)]
            new = getattr(self, f'rfp_module{step - 1}')(img, rfp_feats)
            x_new = self.fpn(new)
            fused = []
            for a, b in zip(x_new, x):
                w = torch.sigmoid(self.rfp_weight(a))
                fused.append(w * a + (1 - w) * b)
            x = tuple(fused)
        return x
