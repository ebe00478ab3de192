"""Shared conv/norm/act building blocks, port of ``tpudet/models/layers.py``,
the dense layer of the RoI heads (flax's ``nn.Dense``), the mask head's
transposed conv (flax's ``nn.ConvTranspose``) and SABL's 1-D conv and
transposed conv.

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
from ..parallel.mesh import (global_sum, is_distributed, process_count,
                             process_index)

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


class ConvTranspose(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` computing in its input's dtype, as ``Conv``:
    flax's ``nn.ConvTranspose`` with padding 0, which gives the same
    output size as flax's ``'SAME'`` where the kernel equals the stride
    (the 2x2 stride-2 upsample of ``FCNMaskHead``). flax correlates the
    dilated input with its kernel unflipped (``transpose_kernel=False``),
    torch with the kernel flipped: ``utils/flax_import`` flips both
    spatial axes on the way in and out. ``kernel_init`` and ``bias_init``
    name tpudet's initializers, as ``Conv``'s."""

    def __init__(self, *args, kernel_init='he_normal', bias_init=0.,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.kernel_init = kernel_init
        self.bias_init = bias_init

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv_transpose2d(x, self.weight.to(x.dtype), bias,
                                  self.stride, self.padding,
                                  self.output_padding, self.groups,
                                  self.dilation)


class Conv1d(nn.Conv1d):
    """``nn.Conv1d`` computing in its input's dtype, as ``Conv``: flax's
    1-D ``nn.Conv`` (kernel (K, in, out)); ``kernel_init`` and
    ``bias_init`` as ``Conv``'s."""

    def __init__(self, *args, kernel_init='he_normal', bias_init=0.,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.kernel_init = kernel_init
        self.bias_init = bias_init

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class ConvTranspose1d(nn.ConvTranspose1d):
    """``nn.ConvTranspose1d`` computing in its input's dtype: flax's 1-D
    ``nn.ConvTranspose`` with its default ``'SAME'`` padding where the
    kernel equals the stride (SABL's 2x upsample), which is torch's
    padding 0. The kernel is flipped on the way in and out
    (``utils/flax_import``), as ``ConvTranspose``'s."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 kernel_init='he_normal', bias_init=0.):
        super().__init__(in_channels, out_channels, kernel_size,
                         stride=kernel_size)
        self.kernel_init = kernel_init
        self.bias_init = bias_init

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv_transpose1d(x, self.weight.to(x.dtype), bias,
                                  self.stride)


def cast_weights(model: nn.Module, dtype: torch.dtype) -> None:
    """Store every conv's and dense layer's parameters in ``dtype``, the
    inference compute dtype (BatchNorm, GroupNorm and the weight-standardized
    convs, which standardize in fp32 at each call, keep fp32)."""
    for m in model.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d,
                          nn.ConvTranspose2d, nn.Linear)) and \
                not getattr(m, 'keeps_fp32', False):
            m.to(dtype)


class _SyncBatchNorm(torch.autograd.Function):
    """BatchNorm's training forward and backward over the batch of every
    rank (tpudet's global statistics, ``tpudet/models/layers.py:95-100``
    under a sharded batch axis): one all-reduce of the statistics in the
    forward, one of two channel sums in the backward.

    The forward all-reduces a (ranks, 2C+1) buffer in which each rank
    fills its own row with its pixel count per channel, its mean and the
    sum of squared deviations about that mean (one fused ``var_mean``
    pass, fp32 or wider), so every rank holds every rank's statistics;
    Chan's formula merges them: ``M2 = sum M2_r + sum n_r (mean_r -
    mean)^2``. No ``E[x^2] - E[x]^2``, which cancels in low precision.
    The output is normalized with the global mean and the biased global
    variance in one ``F.batch_norm`` pass.

    The backward all-reduces ``(sum dy, sum dy x_hat)`` per channel and
    gives ``dx = w invstd (dy - sum dy / N - x_hat sum dy x_hat / N)``;
    the gradients of the scale and bias are this rank's sums, which the
    step's gradient all-reduce adds up."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        stat_dtype = torch.promote_types(x.dtype, torch.float32)
        c = x.shape[1]
        var, mean = torch.var_mean(x.to(stat_dtype), (0, 2, 3),
                                   correction=0)
        n = x.numel() // c
        rows = x.new_zeros((process_count(), 2 * c + 1), dtype=stat_dtype)
        rows[process_index()] = torch.cat([mean.new_full((1,), n), mean,
                                           var * n])
        rows = global_sum(rows)
        counts = rows[:, :1]
        total = counts.sum()
        means = rows[:, 1:c + 1]
        mean = (counts * means).sum(0) / total
        var = (rows[:, c + 1:].sum(0) +
               (counts * (means - mean) ** 2).sum(0)) / total
        y = F.batch_norm(x, mean, var, weight, bias, False, 0., eps)
        ctx.save_for_backward(x, weight, mean, torch.rsqrt(var + eps))
        ctx.total = total
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _mean_grad, _var_grad):
        x, weight, mean, invstd = ctx.saved_tensors
        col = (1, -1, 1, 1)
        dy = dy.to(mean.dtype)
        x_hat = (x.to(mean.dtype) - mean.view(col)) * invstd.view(col)
        local = torch.stack([dy.sum((0, 2, 3)),
                             (dy * x_hat).sum((0, 2, 3))])
        sums = global_sum(local) / ctx.total
        dx = (weight.to(mean.dtype) * invstd).view(col) * (
            dy - sums[0].view(col) - x_hat * sums[1].view(col))
        return dx.to(x.dtype), local[1], local[0], None


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax's running-variance rule in train mode,
    and SyncBN while a process group is open.

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

    While a process group is open (``parallel/mesh.py``, of any size) a
    training forward runs ``_SyncBatchNorm``: the statistics, the
    normalization and the running update are those of every rank's batch
    together, as tpudet's are over its sharded batch axis, and the
    running variance moves toward the biased global variance. Not
    ``nn.SyncBatchNorm``, which moves it toward the unbiased one.
    """

    def forward(self, x):
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        self.num_batches_tracked.add_(1)
        m = (self.momentum if self.momentum is not None
             else 1.0 / float(self.num_batches_tracked))
        if is_distributed():
            y, mean, var = _SyncBatchNorm.apply(x, self.weight, self.bias,
                                                self.eps)
            with torch.no_grad():
                self.running_mean.mul_(1 - m).add_(mean, alpha=m)
                self.running_var.mul_(1 - m).add_(var, alpha=m)
            return y
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
    """conv + BN + act (``tpudet/models/layers.py:63-104``): the conv
    bias-free unless ``bias``, the BN left out with ``use_norm=False``.
    Padding defaults to ``kernel_size // 2``. BN takes the CSP family's
    eps and momentum unless given (YOLOv3's Darknet passes tpudet's
    ConvModule defaults, torch's 1e-5 and 0.1)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 1, stride: int = 1,
                 padding: Optional[int] = None, groups: int = 1,
                 act: ActCfg = 'Mish', bn_eps: float = BN_EPS,
                 bn_momentum: float = BN_MOMENTUM, use_norm: bool = True,
                 bias: bool = False):
        super().__init__()
        pad = kernel_size // 2 if padding is None else padding
        self.conv = Conv(in_channels, out_channels, kernel_size, stride, pad,
                         groups=groups, bias=bias)
        self.bn = (BatchNorm2d(out_channels, eps=bn_eps, momentum=bn_momentum)
                   if use_norm else None)
        self.act = get_activation(act)

    def forward(self, x):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
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
