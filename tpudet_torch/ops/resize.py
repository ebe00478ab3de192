"""Bilinear resize with ``jax.image.resize(x, shape, 'bilinear')``'s
semantics (``antialias=True``, its default), the counterpart of tpudet's
calls in ``htc_roi_head.py:54-56``, ``scnet_roi_head.py:189-190`` and
``point_rend_roi_head.py:295-296``.

Every axis whose size changes is resampled by a weight matrix, as
``jax._src.image.scale.compute_weight_mat`` builds it: output pixel ``o``
samples the input at ``s = (o + 0.5) / scale - 0.5``; input pixel ``i``
weighs ``max(0, 1 - |s - i| / k)`` with ``k = max(1 / scale, 1)`` (a
triangle widened by the ratio when the axis shrinks: an antialiased
downsample, not ``F.interpolate``'s two-tap one); the weights of an output
pixel are divided by their sum (so the taps that fall outside the input
are dropped and the rest renormalised), and an output pixel that samples
outside ``[-0.5, size - 0.5]`` gets none. Upsampling is the usual
half-pixel bilinear with clamped edges.

The weights are computed in fp32 (float64 for a float64 input, as jax
does under x64), cast to the input's dtype, and contracted one axis at a
time in increasing order (one matmul each).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

_EPS32 = float(np.finfo(np.float32).eps)


def weight_matrix(size_in: int, size_out: int, dtype: torch.dtype,
                  device=None) -> torch.Tensor:
    """The (size_in, size_out) resampling weights of one axis, in
    ``dtype``."""
    wdt = torch.float64 if dtype == torch.float64 else torch.float32
    inv_scale = 1.0 / (size_out / size_in)
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(size_out, dtype=wdt, device=device) + 0.5) * \
        inv_scale - 0.5
    x = (sample[None, :] - torch.arange(size_in, dtype=wdt, device=device
                                        )[:, None]).abs() / kernel_scale
    w = torch.clamp_min(1 - x, 0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000. * _EPS32,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= size_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).to(dtype)


def resize_bilinear(x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``x`` resampled to ``shape`` (its rank), every axis whose size
    differs, as ``jax.image.resize(x, shape, 'bilinear')``."""
    shape = tuple(int(s) for s in shape)
    if len(shape) != x.dim():
        raise ValueError(f'resize_bilinear: shape {shape} for a tensor of '
                         f'rank {x.dim()}')
    if not x.is_floating_point():
        x = x.float()
    for d, (n_in, n_out) in enumerate(zip(x.shape, shape)):
        if n_in == n_out:
            continue
        w = weight_matrix(n_in, n_out, x.dtype, x.device)
        x = torch.movedim(torch.movedim(x, d, -1) @ w, -1, d)
    return x
