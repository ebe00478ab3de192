"""Shared conv/norm/act building blocks, port of ``tpudet/models/layers.py``,
and the dense layer of the RoI heads (flax's ``nn.Dense``).

Modules run NCHW (``channels_last`` memory on the card); the detector
takes and returns tpudet's NHWC layout at its surface. Attribute names
follow the flax names (``conv``, ``bn``), so weights map by name
(``utils/flax_import.py``).

Compute dtype, as flax's module ``dtype`` field: convs compute in their
input's dtype and cast fp32 parameters to it at each call, so training
keeps fp32 master weights (inference casts them once, ``set_dtype``).
BatchNorm keeps fp32 parameters and statistics and returns its input's
dtype.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Callable, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.mish import mish_cuda

# the CSP family's BN convention (tpudet/models/layers.py:33, DARKNET_BN:
# eps 1e-3, flax decay 0.97 == torch momentum 0.03)
BN_EPS = 1e-3
BN_MOMENTUM = 0.03

ActCfg = Optional[Union[str, dict]]


def get_activation(act: ActCfg) -> Optional[Callable]:
    """Resolve an activation by the reference's config names
    (``tpudet/models/layers.py:36-60``). Mish runs the port's kernel on
    the card; the others are plain torch ops."""
    if act is None:
        return None
    if isinstance(act, Mapping):
        name = act['type']
        kwargs = {k: v for k, v in act.items() if k != 'type'}
    else:
        name, kwargs = act, {}
    name = name.lower()
    if name == 'mish':
        return mish_cuda
    if name == 'relu':
        return torch.relu
    if name == 'leakyrelu':
        slope = kwargs.get('negative_slope', 0.01)
        return lambda x: F.leaky_relu(x, negative_slope=slope)
    if name in ('swish', 'silu'):
        return F.silu
    if name == 'sigmoid':
        return torch.sigmoid
    if name == 'tanh':
        return torch.tanh
    raise KeyError(f'unknown activation {name}')


class Conv(nn.Conv2d):
    """``nn.Conv2d`` computing in its input's dtype: the weight (and bias)
    are cast to it at the call, as flax's ``nn.Conv(dtype=...)`` casts its
    fp32 params. A no-op cast once ``set_dtype`` has stored them in that
    dtype.

    ``kernel_init`` and ``bias_init`` name tpudet's initializers of the
    flax conv this one stands for; ``utils/flax_import.
    random_flax_variables`` draws by them. ``kernel_init`` is
    ``'he_normal'``, ``'xavier_uniform'`` or ``('normal', std)``;
    ``bias_init`` a number or an array of the bias's shape."""

    def __init__(self, *args, kernel_init='he_normal', bias_init=0.,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.kernel_init = kernel_init
        self.bias_init = bias_init

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class Dense(nn.Linear):
    """``nn.Linear`` computing in its input's dtype, as ``Conv``: flax's
    ``nn.Dense``. Its ``weight`` is (out, in), the transpose of flax's
    ``kernel`` (in, out); ``kernel_init`` and ``bias_init`` name tpudet's
    initializers (``'xavier_uniform'`` or ``('normal', std)``; a number),
    which ``random_flax_variables`` draws by."""

    def __init__(self, *args, kernel_init='xavier_uniform', bias_init=0.,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.kernel_init = kernel_init
        self.bias_init = bias_init

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


def cast_weights(model: nn.Module, dtype: torch.dtype) -> None:
    """Store every conv's and dense layer's parameters in ``dtype``, the
    inference compute dtype (BatchNorm keeps fp32)."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            m.to(dtype)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax's running-variance rule in train mode.

    Both normalize with the batch mean and the biased batch variance, but
    torch moves ``running_var`` toward the *unbiased* variance
    (``n/(n-1)`` times the biased one) where flax (``tpudet/models/
    layers.py:95-100``) and tpudet's ``PhaseBatchNorm`` use the biased
    one. This keeps ``F.batch_norm``'s one fused pass (statistics, saved
    mean and inverse std for the backward, cuDNN on the card) and corrects
    its update afterwards: ``F.batch_norm`` moves a copy of the old
    ``running_var`` ``r0`` to ``r = (1-m) r0 + m v n/(n-1)`` (factor ``m``),
    and flax's ``(1-m) r0 + m v`` is ``((n-1) r + (1-m) r0) / n``. The
    correction costs a few ops on (C,) vectors and divides by nothing
    small; computing the statistics a second time would cost a pass over
    the activations. (The copy, not ``running_var`` itself, goes to
    ``F.batch_norm``: autograd keeps its input and refuses a later
    in-place change to it.)
    """

    def forward(self, x):
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        self.num_batches_tracked.add_(1)
        m = (self.momentum if self.momentum is not None
             else 1.0 / float(self.num_batches_tracked))
        var = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, var, self.weight, self.bias,
                         True, m, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_var.copy_(torch.add(var * ((n - 1) / n),
                                             self.running_var,
                                             alpha=(1 - m) / n))
        return y


class Conv2d(nn.Module):
    """Raw bias-free 1x1 conv (the ``nn.Conv2d`` legs of CSP blocks); the
    torch conv is ``self.conv``, as flax names it."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = Conv(in_channels, out_channels, 1, bias=False)

    def forward(self, x):
        return self.conv(x)


class ConvModule(nn.Module):
    """conv (no bias) + BN + act (``tpudet/models/layers.py:63-104``).
    Padding defaults to ``kernel_size // 2``."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 1, stride: int = 1,
                 padding: Optional[int] = None, groups: int = 1,
                 act: ActCfg = 'Mish'):
        super().__init__()
        pad = kernel_size // 2 if padding is None else padding
        self.conv = Conv(in_channels, out_channels, kernel_size, stride, pad,
                         groups=groups, bias=False)
        self.bn = BatchNorm2d(out_channels, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.act = get_activation(act)

    def forward(self, x):
        x = self.bn(self.conv(x))
        return self.act(x) if self.act is not None else x


class BatchNormAct(nn.Module):
    """Shared BN + act over concatenated CSP branches
    (``tpudet/models/layers.py:130-147``)."""

    def __init__(self, channels: int, act: ActCfg = 'Mish'):
        super().__init__()
        self.bn = BatchNorm2d(channels, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.act = get_activation(act)

    def forward(self, x):
        x = self.bn(x)
        return self.act(x) if self.act is not None else x


def max_pool_same(x, kernel_size: int):
    """Stride-1 max pool with same padding (SPP legs). Both frameworks pad
    with -inf, so this equals tpudet's separable form exactly, and so does
    its gradient wherever the window's maximum is unique (both route it to
    the maximum; at a tie each picks one element, maybe another)."""
    return F.max_pool2d(x, kernel_size, 1, kernel_size // 2)


def upsample_nearest_2x(x):
    """Nearest-neighbour 2x upsample (neck top-down path); its gradient sums
    each 2x2 block, as the broadcast of tpudet's form does."""
    return F.interpolate(x, scale_factor=2, mode='nearest')
