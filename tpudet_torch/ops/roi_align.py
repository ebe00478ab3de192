"""RoIAlign: port of ``tpudet/ops/roi_align.py`` (``roi_align``,
``multilevel_roi_align``, ``generic_roi_align``, and ``batched_roi_align``
for tpudet's ``vmap`` of ``roi_align`` over maps) as torch ops, with
tpudet's semantics:

- sample points at ``roi_start + (i + 0.5) * bin / n - 0.5`` in feature
  pixels, ``n = sampling_ratio`` per bin and axis;
- ``roi_w`` and ``roi_h`` at least ``1e-3`` after scaling;
- each of the four bilinear corners reads 0 outside the map (no clamp
  into it);
- a bin is the mean of its ``n x n`` samples;
- on an FPN, a roi's level is ``floor(log2(sqrt(area) / 56 + 1e-6))``
  clamped to the levels, and an invalid roi pools to 0; GRoIE's generic
  extractor pools every roi from every level and sums (or concatenates)
  the levels.

tpudet pools every roi from every level and masks; here each roi is
pooled at its own level only, with the same result and no host sync. The
levels' NHWC maps are flattened into one ``(sum B*H*W, C)`` table; a roi
carries its level's row offset, ``H``, ``W`` and scale, so every bin is
one weighted sum of ``4 n^2`` table rows (``F.embedding_bag``,
``mode='sum'``): one gather pass, no corner tensor materialised. A corner
outside the map, or any corner of an invalid roi, gets weight 0. The
weights take the table's dtype (bf16 at bf16 inference); the sums
accumulate in fp32 on the card. The gradient with respect to the
features flows through autograd of these ops.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def roi_levels(rois: torch.Tensor, num_levels: int,
               finest_scale: int = 56) -> torch.Tensor:
    """The FPN level of each roi (``..., 4`` xyxy image coords), mmcv's
    ``SingleRoIExtractor`` mapping as tpudet computes it, int64."""
    areas = torch.clamp_min((rois[..., 2] - rois[..., 0]) *
                            (rois[..., 3] - rois[..., 1]), 1e-6)
    target = torch.floor(torch.log2(torch.sqrt(areas) / finest_scale + 1e-6))
    return torch.clamp(target, 0, num_levels - 1).long()


def _axis_taps(start, extent, size, out_size: int, n: int):
    """Row (or column) taps of the samples along one axis: per roi, bin,
    sample and corner (``N, out, n, 2``) the clamped pixel index and the
    bilinear weight, 0 where the corner lies outside ``[0, size)``."""
    grid = (torch.arange(out_size * n, dtype=torch.float32,
                         device=start.device) + 0.5) / n
    pos = start[:, None] + grid[None, :] * (extent / out_size)[:, None] - 0.5
    lo = torch.floor(pos)
    frac = pos - lo
    corner = torch.stack([lo, lo + 1], dim=-1)  # (N, out*n, 2)
    weight = torch.stack([1 - frac, frac], dim=-1)
    inside = (corner >= 0) & (corner < size[:, None, None])
    idx = torch.minimum(torch.clamp_min(corner, 0),
                        (size - 1)[:, None, None]).long()
    weight = torch.where(inside, weight, torch.zeros_like(weight))
    shape = (start.shape[0], out_size, n, 2)
    return idx.reshape(shape), weight.reshape(shape)


def _pool(table: torch.Tensor, rois: torch.Tensor, base: torch.Tensor,
          scale: torch.Tensor, height: torch.Tensor, width: torch.Tensor,
          keep: torch.Tensor, out_size: int, n: int) -> torch.Tensor:
    """Pool (N, 4) rois from ``table`` (rows ``base + y * width + x`` of a
    map ``height x width`` per roi, features of ``scale``), masked by
    ``keep``: (N, out, out, C)."""
    boxes = rois.float() * scale[:, None]
    x1, y1 = boxes[:, 0], boxes[:, 1]
    roi_w = torch.clamp_min(boxes[:, 2] - x1, 1e-3)
    roi_h = torch.clamp_min(boxes[:, 3] - y1, 1e-3)
    ty, wy = _axis_taps(y1, roi_h, height.float(), out_size, n)
    tx, wx = _axis_taps(x1, roi_w, width.float(), out_size, n)
    # (N, bin y, bin x, sample y, sample x, corner y, corner x)
    ty, wy = ty[:, :, None, :, None, :, None], wy[:, :, None, :, None, :, None]
    tx, wx = tx[:, None, :, None, :, None, :], wx[:, None, :, None, :, None, :]
    rows = (base[:, None, None, None, None, None, None] +
            ty * width[:, None, None, None, None, None, None] + tx)
    wts = wy * wx * (keep.float() / (n * n))[:, None, None, None, None, None,
                                             None]
    taps = 4 * n * n
    pooled = F.embedding_bag(rows.reshape(-1, taps), table,
                             per_sample_weights=wts.reshape(-1, taps).to(
                                 table.dtype), mode='sum')
    return pooled.reshape(rois.shape[0], out_size, out_size, -1)


def roi_align(feat: torch.Tensor, rois: torch.Tensor, out_size: int = 7,
              spatial_scale: float = 1.0,
              sampling_ratio: int = 2) -> torch.Tensor:
    """One feature map: ``feat`` (H, W, C), ``rois`` (P, 4) xyxy in image
    coords -> (P, out_size, out_size, C)."""
    h, w, c = feat.shape
    p = rois.shape[0]
    full = lambda v, dt: torch.full((p,), v, dtype=dt,  # noqa: E731
                                    device=rois.device)
    return _pool(feat.reshape(h * w, c), rois, full(0, torch.long),
                 full(spatial_scale, torch.float32), full(h, torch.long),
                 full(w, torch.long), full(True, torch.bool), out_size,
                 sampling_ratio)


def batched_roi_align(maps: torch.Tensor, rois: torch.Tensor,
                      out_size: int = 7, spatial_scale: float = 1.0,
                      sampling_ratio: int = 2) -> torch.Tensor:
    """One map per row: ``maps`` (N, H, W, C), ``rois`` (N, P, 4) xyxy ->
    (N, P, out_size, out_size, C), roi ``p`` of row ``n`` pooled from map
    ``n`` (tpudet's ``vmap`` of ``roi_align``; no roi is masked)."""
    n, h, w, c = maps.shape
    p = rois.shape[1]
    dev = rois.device
    full = lambda v, dt: torch.full((n * p,), v, dtype=dt,  # noqa: E731
                                    device=dev)
    base = torch.arange(n, device=dev).repeat_interleave(p) * (h * w)
    pooled = _pool(maps.reshape(n * h * w, c), rois.reshape(-1, 4), base,
                   full(spatial_scale, torch.float32), full(h, torch.long),
                   full(w, torch.long), full(True, torch.bool), out_size,
                   sampling_ratio)
    return pooled.reshape(n, p, out_size, out_size, c)


def batched_multilevel_roi_align(feats: Sequence[torch.Tensor],
                                 rois: torch.Tensor, roi_valid: torch.Tensor,
                                 out_size: int = 7,
                                 strides: Sequence[int] = (4, 8, 16, 32),
                                 sampling_ratio: int = 2,
                                 finest_scale: int = 56) -> torch.Tensor:
    """FPN RoIAlign over a batch: ``feats`` per level (B, H_l, W_l, C)
    (an NHWC view of a channels-last map costs no copy), ``rois`` (B, P,
    4) xyxy image coords, ``roi_valid`` (B, P) -> (B, P, out, out, C);
    each roi from the level of its size (``roi_levels``), invalid rois 0.
    """
    feats = list(feats)[:len(strides)]
    b, p = rois.shape[:2]
    dev = rois.device
    table = torch.cat([f.reshape(-1, f.shape[-1]) for f in feats])
    hw = torch.tensor([f.shape[1:3] for f in feats], dtype=torch.long,
                      device=dev)
    sizes = [b * f.shape[1] * f.shape[2] for f in feats]
    offsets = torch.tensor([sum(sizes[:i]) for i in range(len(sizes))],
                           dtype=torch.long, device=dev)
    scales = torch.tensor([1.0 / s for s in strides], dtype=torch.float32,
                          device=dev)
    level = roi_levels(rois, len(feats), finest_scale).reshape(-1)
    img = torch.arange(b, device=dev).repeat_interleave(p)
    height, width = hw[level, 0], hw[level, 1]
    base = offsets[level] + img * height * width
    pooled = _pool(table, rois.reshape(-1, 4), base, scales[level], height,
                   width, roi_valid.reshape(-1), out_size, sampling_ratio)
    return pooled.reshape(b, p, out_size, out_size, -1)


def multilevel_roi_align(feats: Sequence[torch.Tensor], rois: torch.Tensor,
                         roi_valid: torch.Tensor, out_size: int = 7,
                         strides: Sequence[int] = (4, 8, 16, 32),
                         sampling_ratio: int = 2,
                         finest_scale: int = 56) -> torch.Tensor:
    """One image, as tpudet's: ``feats`` per level (H_l, W_l, C), ``rois``
    (P, 4), ``roi_valid`` (P,) -> (P, out, out, C)."""
    return batched_multilevel_roi_align(
        [f[None] for f in feats], rois[None], roi_valid[None], out_size,
        strides, sampling_ratio, finest_scale)[0]


def batched_generic_roi_align(feats: Sequence[torch.Tensor],
                              rois: torch.Tensor, roi_valid: torch.Tensor,
                              out_size: int = 7,
                              strides: Sequence[int] = (4, 8, 16, 32),
                              sampling_ratio: int = 2,
                              aggregation: str = 'sum') -> torch.Tensor:
    """GRoIE's generic extractor over a batch: every roi pooled from every
    level of ``feats`` (B, H_l, W_l, C), in one gather pass, then the
    levels summed in their order (``aggregation='sum'``: (B, P, out, out,
    C)) or concatenated along the channels (``'concat'``: (B, P, out,
    out, C * levels)); invalid rois 0."""
    if aggregation not in ('sum', 'concat'):
        raise ValueError(f'unknown aggregation {aggregation!r}')
    feats = list(feats)[:len(strides)]
    b, p = rois.shape[:2]
    dev = rois.device
    n_lvl = len(feats)
    table = torch.cat([f.reshape(-1, f.shape[-1]) for f in feats])
    sizes = [b * f.shape[1] * f.shape[2] for f in feats]
    img = torch.arange(b, device=dev).repeat_interleave(p)

    def per_level(values, dtype):  # (levels,) -> (levels * B * P,)
        return torch.tensor(values, dtype=dtype, device=dev
                            ).repeat_interleave(b * p)
    height = per_level([f.shape[1] for f in feats], torch.long)
    width = per_level([f.shape[2] for f in feats], torch.long)
    base = per_level([sum(sizes[:i]) for i in range(n_lvl)], torch.long) + \
        img.repeat(n_lvl) * height * width
    pooled = _pool(table, rois.reshape(-1, 4).repeat(n_lvl, 1), base,
                   per_level([1.0 / s for s in strides[:n_lvl]],
                             torch.float32),
                   height, width, roi_valid.reshape(-1).repeat(n_lvl),
                   out_size, sampling_ratio)
    pooled = pooled.reshape(n_lvl, b, p, out_size, out_size, -1)
    if aggregation == 'concat':
        return torch.cat(list(pooled), dim=-1)
    out = pooled[0]
    for lvl in range(1, n_lvl):  # tpudet's order of the sum
        out = out + pooled[lvl]
    return out


def generic_roi_align(feats: Sequence[torch.Tensor], rois: torch.Tensor,
                      roi_valid: torch.Tensor, out_size: int = 7,
                      strides: Sequence[int] = (4, 8, 16, 32),
                      sampling_ratio: int = 2,
                      aggregation: str = 'sum') -> torch.Tensor:
    """One image, as tpudet's ``generic_roi_align`` (``tpudet/ops/
    roi_align.py:100-124``): ``feats`` per level (H_l, W_l, C), ``rois``
    (P, 4), ``roi_valid`` (P,) -> (P, out, out, C), or (P, out, out,
    C * levels) for ``'concat'``."""
    return batched_generic_roi_align(
        [f[None] for f in feats], rois[None], roi_valid[None], out_size,
        strides, sampling_ratio, aggregation)[0]
