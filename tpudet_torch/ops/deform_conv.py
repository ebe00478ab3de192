"""Deformable convolution v1/v2: port of ``tpudet/ops/deform_conv.py``
(``deform_sample``, ``deform_conv2d``, ``DeformConv2d``,
``ModulatedDeformConv2d``) as torch ops.

tpudet computes it in XLA, not in a Pallas kernel, so the port has no
hand kernel for it. Semantics are tpudet's (mmcv's): per output position
``p`` and kernel tap ``k`` the input is sampled bilinearly at ``p *
stride + dilation * k_offset - pad + learned_offset[p, k]``, ``pad =
dilation * (K - 1) // 2`` on both sides, each of the four corners
reading 0 outside the map (no clamp into it); v2 multiplies each tap by
a sigmoid mask. Offsets are ordered ``(dy0, dx0, dy1, dx1, ...)`` over the
row-major taps.

The functions take tpudet's layouts: ``x`` (B, H, W, C), offsets (B, Ho,
Wo, 2 K^2), mask (B, Ho, Wo, K^2), the kernel (K^2, C, C_out). Every tap
of every position is one weighted sum of four rows of the flattened (B H
W, C) map (``F.embedding_bag``, ``mode='sum'``): a corner outside the map
gets weight 0 and its row index is clipped into the map, as tpudet's
``_bilinear_gather`` zeroes the value it read at the clipped index. The
mask is folded into the four weights. No ``F.grid_sample``: its
coordinate normalisation rounds the sample points differently.

The modules take and return NCHW (``channels_last`` memory on the card,
where the NHWC view the sampling needs is free). As tpudet's, they cast
the input, offsets, mask, kernel and bias to fp32 and return fp32,
whatever the input's dtype (bf16 on the card, float64 in the tests).
``ModulatedDeformConv2d``'s ``conv_offset`` is flax's ``nn.Conv(3 K^2,
'SAME')`` with zero init: it pads like flax's ``'SAME'`` (asymmetric at
stride 2: (0, 1) on an even side, (1, 1) on an odd one) and computes in
the promotion of its input's dtype and its params' (fp32), as flax's
conv with no ``dtype`` does on a bf16 input with fp32 params.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def _bilinear_rows(xs, ys, h: int, w: int):
    """Sample coordinates (any shape) -> the four corners' row indices
    into a flattened (H*W) map, (..., 4) int64, and their bilinear
    weights, (..., 4), 0 where the corner lies outside the map."""
    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    dx = xs - x0
    dy = ys - y0
    x0i, y0i = x0.long(), y0.long()
    rows, weights = [], []
    for yi, xi, wt in ((y0i, x0i, (1 - dy) * (1 - dx)),
                       (y0i, x0i + 1, (1 - dy) * dx),
                       (y0i + 1, x0i, dy * (1 - dx)),
                       (y0i + 1, x0i + 1, dy * dx)):
        inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        rows.append(yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1))
        weights.append(torch.where(inside, wt, torch.zeros_like(wt)))
    return torch.stack(rows, -1), torch.stack(weights, -1)


def deform_sample(x, offsets, kernel_size: int, stride: int = 1,
                  dilation: int = 1, mask=None):
    """Sample deformable taps (``tpudet/ops/deform_conv.py:57-95``).

    x: (B, H, W, C); offsets: (B, Ho, Wo, 2*K*K); mask: (B, Ho, Wo, K*K)
    or None. Returns (B, Ho, Wo, K*K, C) sampled (and masked) taps, in
    ``x``'s dtype."""
    b, h, w, c = x.shape
    k = kernel_size
    ho, wo = offsets.shape[1:3]
    pad = (dilation * (k - 1)) // 2
    dev = x.device
    tap = torch.arange(k * k, device=dev)
    base_y = (torch.arange(ho, dtype=offsets.dtype, device=dev) * stride
              )[:, None, None] + (tap // k * dilation - pad).to(offsets.dtype)
    base_x = (torch.arange(wo, dtype=offsets.dtype, device=dev) * stride
              )[None, :, None] + (tap % k * dilation - pad).to(offsets.dtype)
    off = offsets.reshape(b, ho, wo, k * k, 2)
    ys = base_y[None] + off[..., 0]  # (B, Ho, Wo, K*K)
    xs = base_x[None] + off[..., 1]
    rows, weights = _bilinear_rows(xs, ys, h, w)
    if mask is not None:
        weights = weights * mask.reshape(b, ho, wo, k * k)[..., None]
    rows = rows + (torch.arange(b, device=dev) * (h * w)).view(b, 1, 1, 1, 1)
    taps = F.embedding_bag(rows.reshape(-1, 4), x.reshape(b * h * w, c),
                           per_sample_weights=weights.reshape(-1, 4).to(
                               x.dtype), mode='sum')
    return taps.reshape(b, ho, wo, k * k, c)


def deform_conv2d(x, offsets, weight, kernel_size: int, stride: int = 1,
                  dilation: int = 1, mask=None, bias=None):
    """x (B, H, W, C); weight (K*K, C, Cout); offsets (B, Ho, Wo, 2KK) ->
    (B, Ho, Wo, Cout): the taps contracted with the kernel
    (``deform_conv.py:98-105``)."""
    taps = deform_sample(x, offsets, kernel_size, stride, dilation, mask)
    b, ho, wo = taps.shape[:3]
    out = taps.reshape(b * ho * wo, -1) @ weight.reshape(-1, weight.shape[-1])
    if bias is not None:
        out = out + bias
    return out.reshape(b, ho, wo, -1)


def same_padding(size: int, kernel_size: int, stride: int,
                 dilation: int = 1):
    """flax's ``'SAME'`` padding of one side, (low, high): the output has
    ``ceil(size / stride)`` positions; the low side gets the smaller half
    of the padding."""
    out = -(-size // stride)
    total = max((out - 1) * stride + (kernel_size - 1) * dilation + 1 - size,
                0)
    return total // 2, total - total // 2


def _kernel_kk_c_o(weight):
    """The (Cout, Cin, K, K) torch weight as tpudet's (K*K, Cin, Cout)."""
    return weight.flatten(2).permute(2, 1, 0)


class _OffsetConv(nn.Conv2d):
    """``conv_offset``: flax's ``nn.Conv`` with no ``dtype``, which
    computes in the promotion of its input's dtype and its params' (fp32 on
    a bf16 input). Its params stay fp32 under ``layers.cast_weights``, and
    ``random_flax_variables`` draws them at 0, as flax's zero init."""

    keeps_fp32 = True
    kernel_init = 'zeros'

    def forward(self, x):
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        return F.conv2d(x.to(dt), self.weight.to(dt), self.bias.to(dt),
                        self.stride)


class DeformConv2d(nn.Module):
    """v1, offsets given by the caller (mmcv ``DeformConv2d``): flax's
    ``DeformConv2d(features, kernel_size, stride, dilation, use_bias)``.
    ``weight`` is (Cout, Cin, K, K), as a conv's; its flax leaf is
    ``kernel`` (K*K, Cin, Cout), drawn ``he_normal`` over fan-in K*K*Cin
    (``utils/flax_import``'s ``DEFORM`` kind). ``forward(x, offsets)``
    takes NCHW ``x`` and (B, 2KK, Ho, Wo) offsets, and returns fp32
    NCHW."""

    flax_leaves = {'weight': ('kernel', 'deform'), 'bias': ('bias', '')}

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, dilation: int = 1,
                 bias: bool = False):
        super().__init__()
        self.kernel_size, self.stride, self.dilation = (kernel_size, stride,
                                                        dilation)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None
        self.reset_parameters()

    def reset_parameters(self):
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def _deform(self, x, offsets, mask):
        """fp32 NHWC sampling and contraction of NCHW ``x``; NCHW out."""
        f32 = torch.float32
        out = deform_conv2d(
            x.to(f32).permute(0, 2, 3, 1), offsets.to(f32),
            _kernel_kk_c_o(self.weight.to(f32)), self.kernel_size,
            self.stride, self.dilation,
            mask=None if mask is None else mask.to(f32),
            bias=None if self.bias is None else self.bias.to(f32))
        return out.permute(0, 3, 1, 2)

    def forward(self, x, offsets):
        return self._deform(x, offsets.permute(0, 2, 3, 1), None)


class ModulatedDeformConv2d(DeformConv2d):
    """v2 (mmcv ``ModulatedDeformConv2dPack``): flax's
    ``ModulatedDeformConv2d(features, kernel_size, stride, dilation,
    use_bias=True)`` predicting its own offsets: ``conv_offset`` (zero
    init, a bias) gives 3 K^2 channels from ``x``, the first 2 K^2 the
    offsets, the sigmoid of the rest the mask. ``forward(x)`` takes NCHW
    ``x`` and returns fp32 NCHW."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, dilation: int = 1,
                 bias: bool = True):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         dilation, bias)
        k = kernel_size
        self.conv_offset = _OffsetConv(in_channels, 3 * k * k, k, stride)
        nn.init.zeros_(self.conv_offset.weight)
        nn.init.zeros_(self.conv_offset.bias)

    def forward(self, x):
        k = self.kernel_size
        pads = [same_padding(n, k, self.stride) for n in x.shape[-2:]]
        om = self.conv_offset(F.pad(x, (*pads[1], *pads[0]))).permute(
            0, 2, 3, 1)
        return self._deform(x, om[..., :2 * k * k],
                            torch.sigmoid(om[..., 2 * k * k:]))
