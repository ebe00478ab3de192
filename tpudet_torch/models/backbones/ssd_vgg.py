"""SSD's VGG-16 backbone: port of ``tpudet/models/backbones/ssd_vgg.py``
(``L2Norm``, ``SSDVGG`` for 300 and 512 inputs).

The five VGG-16 stages of 3x3 convs with a bias and ReLU (``conv{s}_{j}``),
2x2/2 max-pools after the first four that round up, as flax's ``'SAME'``
(torch's ``ceil_mode``: 300 -> 150 -> 75 -> 38 -> 19), the conv4_3 output
L2-normalised (``l2_norm``), pool5 3x3/1 padded 1, fc6 a 3x3 conv dilated
6, fc7 a 1x1, then the extra layers (``extra{i}``, padded 1 only at k3/s2)
with every second output a pyramid level. Convs draw ``he_normal`` with
zero biases.

SSD512's last extra layer is k4/s1 with no padding on a 2x2 map: in
tpudet (flax) its output is 0x0, so the 7th level holds no anchor. A
torch conv refuses a kernel larger than its padded input; ``conv_or_empty``
returns the 0-sized output flax gives (mmdet pads that layer by 1).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...registry import BACKBONES
from ..layers import Conv

VGG16_STAGES = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))


def conv_or_empty(conv: nn.Conv2d, x):
    """``conv(x)``, or flax's 0-sized output where the padded input is
    smaller than the kernel: the conv of ``x`` zero-padded to the kernel,
    sliced to no row or column (its gradient is 0)."""
    h, w = x.shape[-2:]
    (ph, pw), (kh, kw), (sh, sw) = conv.padding, conv.kernel_size, conv.stride
    short_h, short_w = kh - (h + 2 * ph), kw - (w + 2 * pw)
    if short_h <= 0 and short_w <= 0:
        return conv(x)
    oh = max((h + 2 * ph - kh) // sh + 1, 0)
    ow = max((w + 2 * pw - kw) // sw + 1, 0)
    y = conv(F.pad(x, (0, max(short_w, 0), 0, max(short_h, 0))))
    return y[..., :oh, :ow]


class L2Norm(nn.Module):
    """Channel-wise L2 normalisation with a learnable scale (init 20): the
    norm ``sqrt(sum x^2 + 1e-10)`` over the channels in fp32, ``x / norm *
    scale`` in the promotion of ``x``'s dtype and fp32, cast back to
    ``x``'s."""

    flax_leaves = {'scale': ('scale', '')}
    leaf_init = {'scale': 20.}

    def __init__(self, channels: int, scale_init: float = 20.0):
        super().__init__()
        self.scale = nn.Parameter(torch.full((channels,), scale_init))

    def forward(self, x):
        norm = torch.sqrt(x.float().square().sum(1, keepdim=True) + 1e-10)
        stat = torch.promote_types(x.dtype, torch.float32)
        return (x.to(stat) / norm * self.scale.to(stat).view(1, -1, 1, 1)
                ).to(x.dtype)


@BACKBONES.register_module()
class SSDVGG(nn.Module):
    """``forward`` takes an NCHW image batch and returns the 6 (300) or 7
    (512) pyramid levels, NCHW."""

    def __init__(self, input_size: int = 300, dtype=None):
        super().__init__()
        if dtype is not None:  # tpudet's module field
            raise ValueError(
                f'SSDVGG: dtype={dtype!r} is not a module setting in the '
                f'port; set the compute dtype on the detector '
                f'(SingleStageDetector.set_dtype)')
        self.input_size = input_size
        self.stage_convs = []
        cin = 3
        for stage, (n_convs, ch) in enumerate(VGG16_STAGES):
            names = []
            for j in range(n_convs):
                name = f'conv{stage + 1}_{j + 1}'
                self.add_module(name, Conv(cin, ch, 3, 1, 1))
                names.append(name)
                cin = ch
            self.stage_convs.append(names)
        self.l2_norm = L2Norm(512)
        self.fc6 = Conv(512, 1024, 3, 1, 6, dilation=6)
        self.fc7 = Conv(1024, 1024, 1)
        cin = 1024
        self.num_extra = len(self.extra_setting)
        for i, (ch, k, s) in enumerate(self.extra_setting):
            pad = 1 if (k == 3 and s == 2) else 0
            self.add_module(f'extra{i}', Conv(cin, ch, k, s, pad))
            cin = ch

    @property
    def extra_setting(self):
        """(channels, kernel, stride) of each extra layer."""
        if self.input_size == 300:
            return ((256, 1, 1), (512, 3, 2), (128, 1, 1), (256, 3, 2),
                    (128, 1, 1), (256, 3, 1), (128, 1, 1), (256, 3, 1))
        return ((256, 1, 1), (512, 3, 2), (128, 1, 1), (256, 3, 2),
                (128, 1, 1), (256, 3, 2), (128, 1, 1), (256, 3, 2),
                (128, 1, 1), (256, 4, 1))

    @classmethod
    def out_channels(cls, input_size=300):
        return (512, 1024, 512, 256, 256, 256) if input_size == 300 else \
            (512, 1024, 512, 256, 256, 256, 256)

    def forward(self, x):
        outs = []
        for stage, names in enumerate(self.stage_convs):
            for name in names:
                x = F.relu(getattr(self, name)(x))
            if stage == 3:  # conv4_3
                outs.append(self.l2_norm(x))
            if stage < 4:
                x = F.max_pool2d(x, 2, 2, ceil_mode=True)
            else:  # pool5
                x = F.max_pool2d(x, 3, 1, 1)
        x = F.relu(self.fc6(x))
        x = F.relu(self.fc7(x))
        outs.append(x)
        for i in range(self.num_extra):
            x = F.relu(conv_or_empty(getattr(self, f'extra{i}'), x))
            if i % 2 == 1:
                outs.append(x)
        return tuple(outs)
