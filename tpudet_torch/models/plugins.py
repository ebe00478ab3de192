"""The norm switch and the weight-standardized conv: port of
``tpudet/models/plugins.py:29-77`` (``make_norm``, ``WSConv``).

- ``GroupNorm``: flax's ``nn.GroupNorm`` (``epsilon=1e-5``, groups of
  contiguous channels). The statistics are computed in fp32 or wider,
  whatever the input's dtype, with flax's fast variance ``E[x^2] -
  E[x]^2`` clipped at 0; the output is ``(x - mean) * (rsqrt(var + eps) *
  scale) + bias`` in that dtype, cast back to the input's. It has no
  running statistics, so train and eval mode compute the same.
- ``WSConv``: the kernel standardized per output channel over (H, W,
  I / groups) with the unbiased std, divided by ``std + eps`` (not
  ``sqrt(var + eps)``), in fp32 at every call, then cast to the input's
  dtype; a bias only where tpudet's caller asks for one. Its parameters
  stay fp32 under ``set_dtype``, as tpudet's are.
- ``make_norm``: ``GroupNorm`` for ``'GN'``, else the port's
  ``BatchNorm2d``.

``ContextBlock`` and ``GeneralizedAttention`` come with ROADMAP.md's
"rest of the zoo" item.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm2d, Conv

GN_EPS = 1e-5


class GroupNorm(nn.GroupNorm):
    """flax's ``nn.GroupNorm(num_groups, epsilon=1e-5)`` on NCHW input of
    any memory format; ``weight``/``bias`` are flax's ``scale``/``bias``
    (fp32)."""

    def __init__(self, num_groups: int, num_channels: int,
                 eps: float = GN_EPS):
        super().__init__(num_groups, num_channels, eps=eps)

    def forward(self, x):
        b, c = x.shape[:2]
        g = self.num_groups
        stat = torch.promote_types(x.dtype, torch.float32)
        xg = x.to(stat).unflatten(1, (g, c // g))  # (B, G, C/G, ...)
        dims = tuple(range(2, xg.dim()))
        mean = xg.mean(dims, keepdim=True)
        var = torch.clamp_min(xg.square().mean(dims, keepdim=True) -
                              mean.square(), 0.)
        col = (1, g, c // g) + (1,) * (xg.dim() - 3)
        mul = torch.rsqrt(var + self.eps) * self.weight.to(stat).view(col)
        y = (xg - mean) * mul + self.bias.to(stat).view(col)
        return y.flatten(1, 2).to(x.dtype)


class WSConv(Conv):
    """flax's ``WSConv(features, kernel_size, stride, padding, groups,
    use_bias, eps=1e-5)``: ``he_normal`` kernel, zero bias."""

    keeps_fp32 = True  # ``layers.cast_weights`` leaves it in fp32

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1,
                 padding: Optional[int] = None, groups: int = 1,
                 bias: bool = False, eps: float = 1e-5):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         kernel_size // 2 if padding is None else padding,
                         groups=groups, bias=bias)
        self.eps = eps

    def standardized_weight(self) -> torch.Tensor:
        k = self.weight.to(torch.promote_types(self.weight.dtype,
                                               torch.float32))
        n = k[0].numel()
        mean = k.mean((1, 2, 3), keepdim=True)
        var = (k - mean).square().sum((1, 2, 3), keepdim=True) / max(n - 1, 1)
        return (k - mean) / (torch.sqrt(var) + self.eps)

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.standardized_weight().to(x.dtype), bias,
                        self.stride, self.padding, self.dilation, self.groups)


def make_norm(norm: Optional[str], channels: int, gn_groups: int = 32,
              bn_eps: float = 1e-5, bn_momentum: float = 0.1) -> nn.Module:
    """``GroupNorm`` for ``norm == 'GN'``, else ``BatchNorm2d`` (torch
    ``momentum``; flax's decay is ``1 - momentum``)."""
    if norm == 'GN':
        return GroupNorm(gn_groups, channels)
    return BatchNorm2d(channels, eps=bn_eps, momentum=bn_momentum)
