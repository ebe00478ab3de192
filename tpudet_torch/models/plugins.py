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

And the ResNet plugins, port of ``tpudet/models/plugins.py:80-246``
(``PLUGIN_LAYERS``, ``build_plugin``):

- ``ContextBlock``, GCNet's global-context block: ``'att'`` pooling (a
  1x1 ``conv_mask``, a softmax over H*W, the weighted sum) or ``'avg'``;
  ``channel_mul`` and / or ``channel_add`` transforms
  ``{fusion}_conv1`` -> ``{fusion}_ln`` -> ReLU -> ``{fusion}_conv2``.
  The norm is flax's ``nn.LayerNorm`` (``LayerNorm`` here: the channel
  axis, eps 1e-6, ``E[x^2] - E[x]^2`` in fp32 or wider), not mmcv's
  ``LayerNorm([planes, 1, 1])`` with eps 1e-5.
- ``GeneralizedAttention``, the empirical-attention block with
  ``spatial_range=-1`` (tpudet asserts it): keys and values subsampled by
  slicing ``x[:, ::kv_stride, ::kv_stride]`` (not mmcv's average pool),
  the four energy terms of ``attention_type``, the sine/cosine position
  features of the normalised deltas through bias-free ``appr_geom_y`` /
  ``appr_geom_x``, a softmax over the keys, ``proj_conv`` and ``x + out *
  gamma``. As tpudet it computes the energy, the softmax and the position
  features in ``x``'s dtype (bf16 on the card). ``q_stride`` other than
  1 (no reference config) is refused.

Their convs and Dense layers draw flax's default ``lecun_normal`` with
zero biases; ``gamma``, ``key_content_bias`` and ``geom_bias`` start at
0 (``random_flax_variables`` reads ``leaf_init``).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..registry import Registry
from .layers import BatchNorm2d, Conv, Dense

PLUGIN_LAYERS = Registry('plugin layer')

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


class LayerNorm(nn.LayerNorm):
    """flax's ``nn.LayerNorm()`` over the channel axis of NCHW input
    (flax's last axis of NHWC): eps 1e-6, statistics in fp32 or wider
    (``E[x^2] - E[x]^2`` clipped at 0), ``(x - mean) * (rsqrt(var + eps)
    * scale) + bias``, cast back to the input's dtype. ``weight``/``bias``
    are flax's ``scale``/``bias`` (fp32)."""

    def __init__(self, num_channels: int, eps: float = 1e-6):
        super().__init__(num_channels, eps=eps)

    def forward(self, x):
        stat = torch.promote_types(x.dtype, torch.float32)
        xs = x.to(stat)
        mean = xs.mean(1, keepdim=True)
        var = torch.clamp_min(xs.square().mean(1, keepdim=True) -
                              mean.square(), 0.)
        col = (1, -1) + (1,) * (x.dim() - 2)
        mul = torch.rsqrt(var + self.eps) * self.weight.to(stat).view(col)
        return ((xs - mean) * mul + self.bias.to(stat).view(col)).to(x.dtype)


def _lecun_conv(cin, cout, bias=True):
    return Conv(cin, cout, 1, bias=bias, kernel_init='lecun_normal')


@PLUGIN_LAYERS.register_module()
class ContextBlock(nn.Module):
    """flax's ``ContextBlock(in_channels, ratio=1/16, pooling_type='att',
    fusion_types=('channel_add',))`` on NCHW input."""

    def __init__(self, in_channels: int, ratio: float = 1. / 16,
                 pooling_type: str = 'att',
                 fusion_types: Sequence[str] = ('channel_add',)):
        super().__init__()
        planes = max(int(in_channels * ratio), 1)
        self.pooling_type = pooling_type
        self.fusion_types = tuple(fusion_types)
        if pooling_type == 'att':
            self.conv_mask = _lecun_conv(in_channels, 1)
        for fusion in ('channel_mul', 'channel_add'):
            if fusion in self.fusion_types:
                self.add_module(f'{fusion}_conv1',
                                _lecun_conv(in_channels, planes))
                self.add_module(f'{fusion}_ln', LayerNorm(planes))
                self.add_module(f'{fusion}_conv2',
                                _lecun_conv(planes, in_channels))

    def _transform(self, fusion, context):
        t = getattr(self, f'{fusion}_conv1')(context)
        t = F.relu(getattr(self, f'{fusion}_ln')(t))
        return getattr(self, f'{fusion}_conv2')(t)

    def forward(self, x):
        b, c = x.shape[:2]
        if self.pooling_type == 'att':
            mask = torch.softmax(self.conv_mask(x).reshape(b, -1, 1), dim=1)
            context = torch.bmm(x.reshape(b, c, -1), mask).view(b, c, 1, 1)
        else:
            context = x.mean((2, 3), keepdim=True)
        out = x
        if 'channel_mul' in self.fusion_types:
            out = out * torch.sigmoid(self._transform('channel_mul',
                                                      context))
        if 'channel_add' in self.fusion_types:
            out = out + self._transform('channel_add', context)
        return out


@PLUGIN_LAYERS.register_module()
class GeneralizedAttention(nn.Module):
    """flax's ``GeneralizedAttention(in_channels, spatial_range=-1,
    num_heads=9, position_embedding_dim=-1, position_magnitude=1,
    kv_stride=2, q_stride=1, attention_type='1111')`` on NCHW input.
    ``attention_type`` enables, by its four '0'/'1' characters, the query
    and key content term, the query content and relative position term,
    the key content bias and the relative position bias."""

    flax_leaves = {'gamma': ('gamma', ''),
                   'key_content_bias': ('key_content_bias', ''),
                   'geom_bias': ('geom_bias', '')}
    leaf_init = {'gamma': 0., 'key_content_bias': 0., 'geom_bias': 0.}

    def __init__(self, in_channels: int, spatial_range: int = -1,
                 num_heads: int = 9, position_embedding_dim: int = -1,
                 position_magnitude: int = 1, kv_stride: int = 2,
                 q_stride: int = 1, attention_type: str = '1111'):
        super().__init__()
        if spatial_range != -1:
            raise NotImplementedError(
                f'GeneralizedAttention(spatial_range={spatial_range}): only '
                f'-1 (every reference config) is ported, as tpudet asserts '
                f'(tpudet/models/plugins.py:145)')
        if q_stride != 1:
            raise NotImplementedError(
                f'GeneralizedAttention(q_stride={q_stride}): only 1 (every '
                f'reference config) is ported')
        self.at = [bool(int(ch)) for ch in attention_type]
        self.num_heads = num_heads
        self.qk_dim = self.v_dim = in_channels // num_heads
        self.pos_dim = (position_embedding_dim // 2
                        if position_embedding_dim > 0 else in_channels // 2)
        self.position_magnitude = position_magnitude
        self.kv_stride = kv_stride
        inner = self.qk_dim * num_heads
        at = self.at
        if at[0] or at[1]:
            self.query_conv = _lecun_conv(in_channels, inner, bias=False)
        if at[0] or at[2]:
            self.key_conv = _lecun_conv(in_channels, inner, bias=False)
        self.value_conv = _lecun_conv(in_channels, self.v_dim * num_heads,
                                      bias=False)
        self.key_content_bias = (nn.Parameter(torch.zeros(
            num_heads, self.qk_dim)) if at[2] else None)
        if at[1] or at[3]:
            feats = 2 * (self.pos_dim // 2)
            for name in ('appr_geom_y', 'appr_geom_x'):
                self.add_module(name, Dense(feats, inner, bias=False,
                                            kernel_init='lecun_normal'))
        self.geom_bias = (nn.Parameter(torch.zeros(num_heads, self.qk_dim))
                          if at[3] else None)
        self.proj_conv = _lecun_conv(self.v_dim * num_heads, in_channels,
                                     bias=False)
        self.gamma = nn.Parameter(torch.zeros(1))

    def _heads(self, conv, x):
        """A 1x1 conv of NCHW ``x`` as (B, H*W, heads, dim)."""
        y = conv(x)
        return y.permute(0, 2, 3, 1).reshape(y.shape[0], -1, self.num_heads,
                                              y.shape[1] // self.num_heads)

    def _pos_feat(self, rel, dense):
        """Sine/cosine features of the normalised deltas ``rel`` (Nq, Nk)
        through ``dense``: (Nq, Nk, heads * qk_dim), in ``rel``'s dtype."""
        feat_range = torch.arange(self.pos_dim // 2, dtype=rel.dtype,
                                  device=rel.device)
        dim_mat = torch.pow(100.0, feat_range * 4.0 / self.pos_dim)
        emb = rel[..., None] * self.position_magnitude / dim_mat
        return dense(torch.cat([torch.sin(emb), torch.cos(emb)], -1))

    def forward(self, x):
        at, heads, d = self.at, self.num_heads, self.qk_dim
        b, c, h, w = x.shape
        dt, dev = x.dtype, x.device
        kv = self.kv_stride
        x_kv = x[:, :, ::kv, ::kv] if kv > 1 else x
        hk, wk = x_kv.shape[2:]
        if at[0] or at[1]:
            q = self._heads(self.query_conv, x)
        if at[0] or at[2]:
            k = self._heads(self.key_conv, x_kv)
        v = self._heads(self.value_conv, x_kv)

        energy = x.new_zeros((b, heads, h * w, hk * wk))
        scale = 1.0 / math.sqrt(d)
        if at[0]:
            energy = energy + torch.einsum('bqhd,bkhd->bhqk', q, k) * scale
        if at[2]:
            energy = energy + torch.einsum(
                'hd,bkhd->bhk', self.key_content_bias.to(dt), k)[:, :, None]
        if at[1] or at[3]:
            def axis(n, stride):
                return torch.arange(n, dtype=dt, device=dev) * stride
            rel_y = (axis(h, 1)[:, None] - axis(hk, kv)[None, :]) / h
            rel_x = (axis(w, 1)[:, None] - axis(wk, kv)[None, :]) / w
            ey = self._pos_feat(rel_y, self.appr_geom_y).reshape(
                h, hk, heads, d)
            ex = self._pos_feat(rel_x, self.appr_geom_x).reshape(
                w, wk, heads, d)
            if at[1]:
                qg = q.reshape(b, h, w, heads, d)
                e_y = torch.einsum('byxhd,yzhd->bhyxz', qg, ey) * scale
                e_x = torch.einsum('byxhd,xzhd->bhyxz', qg, ex) * scale
                energy = energy + (e_y[..., :, None] + e_x[..., None, :]
                                   ).reshape(b, heads, h * w, hk * wk)
            if at[3]:
                gb = self.geom_bias.to(dt)
                e_y = torch.einsum('hd,yzhd->hyz', gb, ey)
                e_x = torch.einsum('hd,xzhd->hxz', gb, ex)
                energy = energy + (e_y[None, :, :, None, :, None] +
                                   e_x[None, :, None, :, None, :]
                                   ).reshape(1, heads, h * w, hk * wk)

        attn = torch.softmax(energy, dim=-1)
        out = torch.einsum('bhqk,bkhd->bqhd', attn, v).reshape(
            b, h, w, heads * self.v_dim).permute(0, 3, 1, 2)
        out = self.proj_conv(out)
        return x + out * self.gamma.to(dt)


def build_plugin(cfg: dict, in_channels: int) -> nn.Module:
    """A registered plugin from its config dict (tpudet's ``build_plugin``,
    the reference's ``make_block_plugins``); ``postfix`` is dropped."""
    cfg = dict(cfg)
    kind = cfg.pop('type')
    cfg.pop('postfix', None)
    cls = PLUGIN_LAYERS.get(kind)
    if cls is None:
        raise NotImplementedError(
            f'plugin {kind} is not ported; it comes with ROADMAP.md\'s '
            f'"rest of the zoo" item')
    return cls(in_channels=in_channels, **cfg)
